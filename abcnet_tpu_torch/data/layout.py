"""2-D depiction coordinates for molecular graphs.

Replaces the coordinate generation the reference obtains from RDKit's
drawer (`drawer.GetDrawCoords`, reference rdkit_img_generate.py:132)
and Indigo's `mol.layout()` (indigo_img_generator.py:70). Classic
template-free depiction: fused ring systems are laid out as edge-fused
regular polygons; acyclic atoms are placed by DFS with 120-degree
zig-zag branching; collisions lead to rejection upstream (the reference
rejects crowded depictions too, rdkit_img_generate.py:146-148).

Units: one bond length = 1.0.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..chem.mol import Mol


def _ring_systems(mol: Mol, rings: List[List[int]]) -> List[List[int]]:
    """Group SSSR rings into fused systems (sharing >= 1 atom)."""
    n = len(rings)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for i in range(n):
        for j in range(i + 1, n):
            if set(rings[i]) & set(rings[j]):
                pi, pj = find(i), find(j)
                if pi != pj:
                    parent[pi] = pj
    groups: Dict[int, List[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


def _place_polygon(coords, ring: List[int], placed: Set[int]) -> bool:
    """Place one ring as a regular polygon, anchored on already-placed
    atoms (0: free placement, 1: spiro, 2 adjacent: fused edge)."""
    k = len(ring)
    anchored = [a for a in ring if a in placed]
    R = 0.5 / math.sin(math.pi / k)

    if len(anchored) == 0:
        cx, cy = 0.0, 0.0
        for i, a in enumerate(ring):
            ang = 2 * math.pi * i / k
            coords[a] = (cx + R * math.cos(ang), cy + R * math.sin(ang))
        return True

    if len(anchored) == 1:
        a0 = anchored[0]
        x0, y0 = coords[a0]
        # Centroid away from existing placed atoms near a0.
        ang = _away_direction(coords, placed, x0, y0)
        cx, cy = x0 + R * math.cos(ang), y0 + R * math.sin(ang)
        base = math.atan2(y0 - cy, x0 - cx)
        idx0 = ring.index(a0)
        for step in range(1, k):
            a = ring[(idx0 + step) % k]
            theta = base + 2 * math.pi * step / k
            coords[a] = (cx + R * math.cos(theta), cy + R * math.sin(theta))
        return True

    # Fused edge: find two adjacent anchored atoms in the ring ordering.
    for i in range(k):
        a, b = ring[i], ring[(i + 1) % k]
        if a in placed and b in placed:
            ax, ay = coords[a]
            bx, by = coords[b]
            mx, my = (ax + bx) / 2, (ay + by) / 2
            ex, ey = bx - ax, by - ay
            elen = math.hypot(ex, ey) or 1.0
            # Perpendicular; apothem distance for side length elen.
            apo = elen / (2 * math.tan(math.pi / k))
            px, py = -ey / elen, ex / elen
            # Choose the side with fewer already-placed ring-system atoms.
            side1 = (mx + px * apo, my + py * apo)
            side2 = (mx - px * apo, my - py * apo)
            c1 = _crowding(coords, placed, side1)
            c2 = _crowding(coords, placed, side2)
            cx, cy = side1 if c1 <= c2 else side2
            base = math.atan2(ay - cy, ax - cx)
            target = math.atan2(by - cy, bx - cx)
            idx0 = i
            Rf = math.hypot(ax - cx, ay - cy)
            # Walk direction chosen so step 1 lands on b (= ring[idx0+1]).
            diff = (target - base) % (2 * math.pi)
            direction = 1.0 if abs(diff - 2 * math.pi / k) < \
                abs(diff - (2 * math.pi - 2 * math.pi / k)) else -1.0
            for step in range(2, k):
                atom = ring[(idx0 + step) % k]
                theta = base + direction * 2 * math.pi * step / k
                if atom not in placed:
                    coords[atom] = (cx + Rf * math.cos(theta),
                                    cy + Rf * math.sin(theta))
            return True

    # Bridged/nonadjacent anchors: interpolate remaining atoms on an arc.
    a0 = anchored[0]
    x0, y0 = coords[a0]
    ang = _away_direction(coords, placed, x0, y0)
    cx, cy = x0 + R * math.cos(ang), y0 + R * math.sin(ang)
    base = math.atan2(y0 - cy, x0 - cx)
    idx0 = ring.index(a0)
    for step in range(1, k):
        a = ring[(idx0 + step) % k]
        if a in placed:
            continue
        theta = base + 2 * math.pi * step / k
        coords[a] = (cx + R * math.cos(theta), cy + R * math.sin(theta))
    return True


def _crowding(coords, placed: Set[int], pt: Tuple[float, float]) -> float:
    score = 0.0
    for a in placed:
        if coords[a] is None:
            continue
        d2 = (coords[a][0] - pt[0]) ** 2 + (coords[a][1] - pt[1]) ** 2
        if d2 < 4.0:
            score += 1.0 / (d2 + 1e-3)
    return score


def _away_direction(coords, placed: Set[int], x: float, y: float) -> float:
    """Direction pointing away from nearby placed atoms (for spiro rings)."""
    sx = sy = 0.0
    for a in placed:
        if coords[a] is None:
            continue
        dx, dy = coords[a][0] - x, coords[a][1] - y
        d2 = dx * dx + dy * dy
        if 1e-9 < d2 < 9.0:
            w = 1.0 / d2
            sx += w * dx
            sy += w * dy
    if abs(sx) < 1e-9 and abs(sy) < 1e-9:
        return 0.0
    return math.atan2(-sy, -sx)


def layout(mol: Mol, rng: Optional[random.Random] = None) -> List[Tuple[float, float]]:
    """Compute 2-D coordinates for every atom. Returns [(x, y), ...]."""
    rng = rng or random.Random(0)
    n = mol.num_atoms
    coords: List[Optional[Tuple[float, float]]] = [None] * n
    if n == 0:
        return []
    if n == 1:
        return [(0.0, 0.0)]

    rings = mol.sssr()
    systems = _ring_systems(mol, rings)
    atom_system: Dict[int, int] = {}
    for si, ring_idxs in enumerate(systems):
        for ri in ring_idxs:
            for a in rings[ri]:
                atom_system[a] = si
    system_placed = [False] * len(systems)

    placed: Set[int] = set()

    def place_system(si: int, anchor: Optional[int]) -> None:
        """Lay out a fused ring system. ``anchor`` is an already-placed
        member atom (or None for the very first system)."""
        ring_idxs = list(systems[si])
        ring_idxs.sort(key=lambda ri: (0 if anchor in rings[ri] else 1,
                                       len(rings[ri])))
        # BFS over fused rings, starting from the anchored one.
        pending = list(ring_idxs)
        progressed = True
        while pending and progressed:
            progressed = False
            for ri in list(pending):
                ring = rings[ri]
                anchored = [a for a in ring if a in placed]
                first = not placed or (anchor is None and not any(
                    coords[a] is not None for a in ring))
                if anchored or first or all(
                        coords[a] is None for a in ring):
                    if not anchored and placed and anchor is not None:
                        continue
                    _place_polygon(coords, ring, placed)
                    for a in ring:
                        if coords[a] is not None:
                            placed.add(a)
                    pending.remove(ri)
                    progressed = True
        # Anything left (disconnected numerically): force placement.
        for ri in pending:
            _place_polygon(coords, rings[ri], placed)
            for a in rings[ri]:
                if coords[a] is not None:
                    placed.add(a)
        system_placed[si] = True

    def neighbor_angles_of(a: int) -> List[float]:
        out = []
        ax, ay = coords[a]
        for nb in mol.neighbors(a):
            if coords[nb] is not None:
                out.append(math.atan2(coords[nb][1] - ay,
                                      coords[nb][0] - ax))
        return out

    def candidate_angles(existing: List[float], parity: int) -> List[float]:
        if not existing:
            base = rng.uniform(0, 2 * math.pi)
            return [base, base + 2 * math.pi / 3, base - 2 * math.pi / 3,
                    base + math.pi]
        if len(existing) == 1:
            t = existing[0]
            first = t + (2 * math.pi / 3 if parity == 0 else -2 * math.pi / 3)
            second = t + (-2 * math.pi / 3 if parity == 0 else 2 * math.pi / 3)
            return [first, second, t + math.pi, t + math.pi / 2,
                    t - math.pi / 2]
        # Fill the widest angular gap.
        ex = sorted(a % (2 * math.pi) for a in existing)
        gaps = []
        for i in range(len(ex)):
            a0 = ex[i]
            a1 = ex[(i + 1) % len(ex)] + (2 * math.pi if i == len(ex) - 1
                                          else 0)
            gaps.append(((a1 - a0), (a0 + a1) / 2))
        gaps.sort(reverse=True)
        return [g[1] for g in gaps]

    # Start: largest ring system, else atom 0.
    if systems:
        si0 = max(range(len(systems)),
                  key=lambda s: sum(len(rings[r]) for r in systems[s]))
        place_system(si0, None)
    else:
        coords[0] = (0.0, 0.0)
        placed.add(0)

    # DFS placement of everything else.
    stack = sorted(placed) or [0]
    depth: Dict[int, int] = {a: 0 for a in stack}
    visited_for_expand: Set[int] = set()
    while stack:
        a = stack.pop()
        if a in visited_for_expand:
            continue
        visited_for_expand.add(a)
        ax, ay = coords[a]
        unplaced = [nb for nb in mol.neighbors(a) if coords[nb] is None]
        unplaced.sort()
        for nb in unplaced:
            if coords[nb] is not None:
                continue
            existing = neighbor_angles_of(a)
            parity = depth.get(a, 0) % 2
            cands = candidate_angles(existing, parity)
            # Pick the candidate maximizing clearance from placed atoms.
            def clearance(ang):
                px, py = ax + math.cos(ang), ay + math.sin(ang)
                return min(
                    ((coords[o][0] - px) ** 2 + (coords[o][1] - py) ** 2)
                    for o in placed if coords[o] is not None)

            best, best_score = None, -1e18
            for ang in cands:
                score = clearance(ang)
                if best is None or score > best_score + 1e-9:
                    best, best_score = ang, score
                if best_score > 0.99:  # clear enough; keep preference order
                    break
            if best_score < 0.25:
                # Congested: sweep 24 jittered directions for daylight.
                for kk in range(24):
                    ang = 2 * math.pi * kk / 24 + rng.uniform(-0.08, 0.08)
                    score = clearance(ang)
                    if score > best_score + 1e-9:
                        best, best_score = ang, score
            ang = best if best is not None else 0.0
            si = atom_system.get(nb)
            if si is not None and not system_placed[si]:
                coords[nb] = (ax + math.cos(ang), ay + math.sin(ang))
                placed.add(nb)
                place_system(si, nb)
                for m in list(placed):
                    if m not in visited_for_expand and m not in stack:
                        stack.append(m)
                        depth.setdefault(m, depth.get(a, 0) + 1)
            else:
                coords[nb] = (ax + math.cos(ang), ay + math.sin(ang))
                placed.add(nb)
                depth[nb] = depth.get(a, 0) + 1
                stack.append(nb)
        # Re-push a if it still has unplaced neighbors (shouldn't happen).

    # Disconnected fragments: place side by side.
    for a in range(n):
        if coords[a] is None:
            # New fragment root: shift right of current bounding box.
            xs = [c[0] for c in coords if c is not None]
            offset = (max(xs) + 2.0) if xs else 0.0
            coords[a] = (offset, 0.0)
            placed.add(a)
            stack = [a]
            visited_for_expand.discard(a)
            depth[a] = 0
            while stack:
                v = stack.pop()
                if v in visited_for_expand:
                    continue
                visited_for_expand.add(v)
                vx, vy = coords[v]
                for nb in sorted(mol.neighbors(v)):
                    if coords[nb] is None:
                        existing = neighbor_angles_of(v)
                        cands = candidate_angles(existing,
                                                 depth.get(v, 0) % 2)
                        ang = cands[0]
                        coords[nb] = (vx + math.cos(ang), vy + math.sin(ang))
                        placed.add(nb)
                        depth[nb] = depth.get(v, 0) + 1
                        stack.append(nb)

    return [c if c is not None else (0.0, 0.0) for c in coords]


def min_atom_distance(coords: Sequence[Tuple[float, float]]) -> float:
    n = len(coords)
    best = float("inf")
    for i in range(n):
        for j in range(i + 1, n):
            d = math.hypot(coords[i][0] - coords[j][0],
                           coords[i][1] - coords[j][1])
            best = min(best, d)
    return best
