"""Molecular graph data structure for the standalone chemistry core.

Plays the role RDKit's ``Mol`` plays in the reference pipeline
(reference src/generate_smiles.py:115, rdkit_img_generate.py:54):
a small mutable graph of atoms and bonds with aromatic flags, formal
charges, wedge/hash annotations and 2-D coordinates, plus sanitization
(kekulization, aromaticity perception, implicit-H assignment).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from . import periodic

# Bond stereo annotations (MolBlock wedge conventions).
STEREO_NONE = 0
STEREO_WEDGE = 1   # solid wedge, narrow end at atom a
STEREO_HASH = 6    # hashed wedge, narrow end at atom a


@dataclass
class Atom:
    symbol: str
    charge: int = 0
    # None = implicit (computed by sanitize); an int pins the H count
    # (bracket atoms in SMILES, MRV_IMPLICIT_H Sgroups in MolBlocks).
    num_explicit_hs: Optional[int] = None
    aromatic: bool = False
    # Implicit H count, filled in by Mol.sanitize().
    implicit_hs: int = 0
    # 2-D depiction coordinates (layout units or pixels, context-dependent).
    x: float = 0.0
    y: float = 0.0
    isotope: int = 0
    # Tetrahedral parity in the reference neighbor order (chem/stereo.py):
    # 0 none, 1 '@', 2 '@@'.
    parity: int = 0

    @property
    def total_hs(self) -> int:
        if self.num_explicit_hs is not None:
            return self.num_explicit_hs
        return self.implicit_hs

    @property
    def atomic_number(self) -> int:
        return periodic.ATOMIC_NUMBERS.get(self.symbol, 0)


@dataclass
class Bond:
    a: int
    b: int
    # Kekulized bond order: 1, 2, or 3. For aromatic bonds this is the
    # kekule assignment; ``aromatic`` carries the delocalization flag.
    order: int = 1
    aromatic: bool = False
    stereo: int = STEREO_NONE  # wedge/hash, narrow end at atom ``a``
    # Cis/trans tag for double bonds, reference-substituent convention
    # (chem/ez.py): 0 none, 1 cis, 2 trans.
    ez: int = 0

    def other(self, idx: int) -> int:
        return self.b if idx == self.a else self.a


class MolError(ValueError):
    pass


class Mol:
    """A small molecular graph with explicit adjacency."""

    def __init__(self) -> None:
        self.atoms: List[Atom] = []
        self.bonds: List[Bond] = []
        self._adj: List[List[int]] = []  # atom idx -> list of bond indices

    # -- construction ------------------------------------------------------

    def add_atom(self, atom: Atom) -> int:
        self.atoms.append(atom)
        self._adj.append([])
        return len(self.atoms) - 1

    def add_bond(self, a: int, b: int, order: int = 1, aromatic: bool = False,
                 stereo: int = STEREO_NONE) -> int:
        if a == b:
            raise MolError(f"self-bond on atom {a}")
        if self.bond_between(a, b) is not None:
            raise MolError(f"duplicate bond {a}-{b}")
        bond = Bond(a, b, order=order, aromatic=aromatic, stereo=stereo)
        self.bonds.append(bond)
        idx = len(self.bonds) - 1
        self._adj[a].append(idx)
        self._adj[b].append(idx)
        return idx

    # -- queries -----------------------------------------------------------

    @property
    def num_atoms(self) -> int:
        return len(self.atoms)

    @property
    def num_bonds(self) -> int:
        return len(self.bonds)

    def bonds_of(self, idx: int) -> List[Bond]:
        return [self.bonds[i] for i in self._adj[idx]]

    def bond_indices_of(self, idx: int) -> List[int]:
        return list(self._adj[idx])

    def neighbors(self, idx: int) -> List[int]:
        return [self.bonds[i].other(idx) for i in self._adj[idx]]

    def bond_between(self, a: int, b: int) -> Optional[Bond]:
        for i in self._adj[a] if a < len(self._adj) else []:
            bond = self.bonds[i]
            if bond.other(a) == b:
                return bond
        return None

    def degree(self, idx: int) -> int:
        return len(self._adj[idx])

    def bond_order_sum(self, idx: int, aromatic_as_kekule: bool = True) -> int:
        """Sum of bond orders at an atom using the kekulized orders."""
        total = 0
        for bond in self.bonds_of(idx):
            total += bond.order
        return total

    def copy(self) -> "Mol":
        out = Mol()
        for a in self.atoms:
            out.add_atom(Atom(a.symbol, a.charge, a.num_explicit_hs,
                              a.aromatic, a.implicit_hs, a.x, a.y,
                              a.isotope, a.parity))
        for b in self.bonds:
            bi = out.add_bond(b.a, b.b, b.order, b.aromatic, b.stereo)
            out.bonds[bi].ez = b.ez
        return out

    def strip_stereo(self) -> "Mol":
        """Copy with all stereochemistry removed: tetrahedral parities,
        cis/trans tags, wedge/hash annotations.

        The non-isomeric output mode — role of the reference's
        ``MolToSmiles(..., isomericSmiles=False)`` in its second accuracy
        metric (cal_acc.py:35-36)."""
        out = self.copy()
        for a in out.atoms:
            a.parity = 0
        for b in out.bonds:
            b.ez = 0
            b.stereo = STEREO_NONE
        return out

    # -- ring perception ---------------------------------------------------

    def ring_bond_flags(self) -> List[bool]:
        """Per-bond flag: is the bond part of any cycle?

        A bond is in a ring iff removing it leaves its endpoints connected —
        equivalently iff it is not a bridge. Computed via Tarjan bridges.
        """
        n = self.num_atoms
        disc = [-1] * n
        low = [0] * n
        is_bridge = [False] * self.num_bonds
        timer = [0]

        for root in range(n):
            if disc[root] != -1:
                continue
            # Iterative DFS to avoid recursion limits on long chains.
            stack: List[Tuple[int, int, int]] = [(root, -1, 0)]
            order: List[Tuple[int, int]] = []
            while stack:
                v, parent_bond, ptr = stack.pop()
                if ptr == 0:
                    disc[v] = low[v] = timer[0]
                    timer[0] += 1
                adj = self._adj[v]
                advanced = False
                while ptr < len(adj):
                    bi = adj[ptr]
                    ptr += 1
                    if bi == parent_bond:
                        continue
                    u = self.bonds[bi].other(v)
                    if disc[u] == -1:
                        stack.append((v, parent_bond, ptr))
                        stack.append((u, bi, 0))
                        order.append((v, bi))
                        advanced = True
                        break
                    low[v] = min(low[v], disc[u])
                if not advanced and ptr >= len(adj):
                    # post-visit: propagate low-link to parent
                    if parent_bond != -1:
                        p = self.bonds[parent_bond].other(v)
                        low[p] = min(low[p], low[v])
                        if low[v] > disc[p]:
                            is_bridge[parent_bond] = True
        return [not b for b in is_bridge]

    def sssr(self, max_ring: int = 24) -> List[List[int]]:
        """A smallest-set-of-smallest-rings approximation.

        For every ring bond, find the shortest cycle through it by BFS in
        the graph with that bond removed; deduplicate by atom set. This
        yields the "relevant rings" used for aromaticity perception —
        sufficient for the fused-ring systems in drug-like molecules.
        """
        ring_flags = self.ring_bond_flags()
        rings: List[List[int]] = []
        seen: set = set()
        for bi, bond in enumerate(self.bonds):
            if not ring_flags[bi]:
                continue
            path = self._shortest_path(bond.a, bond.b, skip_bond=bi,
                                       max_len=max_ring)
            if path is None:
                continue
            key = frozenset(path)
            if key in seen:
                continue
            seen.add(key)
            rings.append(path)
        rings.sort(key=len)
        return rings

    def _shortest_path(self, src: int, dst: int, skip_bond: int,
                       max_len: int) -> Optional[List[int]]:
        from collections import deque
        prev: Dict[int, int] = {src: -1}
        q = deque([(src, 0)])
        while q:
            v, d = q.popleft()
            if d >= max_len:
                continue
            for bi in self._adj[v]:
                if bi == skip_bond:
                    continue
                u = self.bonds[bi].other(v)
                if u in prev:
                    continue
                prev[u] = v
                if u == dst:
                    path = [u]
                    while path[-1] != src:
                        path.append(prev[path[-1]])
                    return path
                q.append((u, d + 1))
        return None

    def ring_atom_flags(self) -> List[bool]:
        flags = [False] * self.num_atoms
        ring_bonds = self.ring_bond_flags()
        for bi, bond in enumerate(self.bonds):
            if ring_bonds[bi]:
                flags[bond.a] = True
                flags[bond.b] = True
        return flags

    # -- sanitization ------------------------------------------------------

    def assign_implicit_hydrogens(self) -> None:
        for i, atom in enumerate(self.atoms):
            if atom.num_explicit_hs is not None:
                atom.implicit_hs = atom.num_explicit_hs
                continue
            bos = self.bond_order_sum(i)
            atom.implicit_hs = periodic.implicit_hydrogens(
                atom.symbol, atom.charge, bos)

    def sanitize(self) -> "Mol":
        """Kekulize aromatic systems, then assign implicit hydrogens.

        Call after building from SMILES (aromatic bonds carry order=1 until
        kekulization) or from a MolBlock (order 4 = aromatic).
        """
        from .aromaticity import kekulize
        kekulize(self)
        self.assign_implicit_hydrogens()
        return self

    def remove_explicit_h_atoms(self) -> "Mol":
        """Return a copy with degree-1 neutral H atoms merged away.

        Mirrors RDKit's ``removeHs`` default when parsing MolBlocks: an
        explicit hydrogen atom bonded once to a heavy atom disappears and
        the heavy atom's hydrogen count is recomputed implicitly.
        """
        keep = []
        for i, a in enumerate(self.atoms):
            is_plain_h = (a.symbol == "H" and a.charge == 0
                          and self.degree(i) == 1 and a.isotope == 0
                          and self.atoms[self.neighbors(i)[0]].symbol != "H")
            if not is_plain_h:
                keep.append(i)
        if len(keep) == self.num_atoms:
            return self
        remap = {old: new for new, old in enumerate(keep)}
        out = Mol()
        for old in keep:
            a = self.atoms[old]
            out.add_atom(Atom(a.symbol, a.charge, a.num_explicit_hs,
                              a.aromatic, a.implicit_hs, a.x, a.y, a.isotope))
        ez_transfer = []
        for old_bi, b in enumerate(self.bonds):
            if b.a in remap and b.b in remap:
                bi = out.add_bond(remap[b.a], remap[b.b], b.order,
                                  b.aromatic, b.stereo)
                if b.ez:
                    ez_transfer.append((old_bi, bi, b.ez))
        # Tetrahedral parities: a removed explicit H becomes the virtual
        # neighbor (reference-order remap, chem/stereo.py).
        from .stereo import VIRTUAL, map_parity, reference_order
        for old in keep:
            p = self.atoms[old].parity
            if not p:
                continue
            old_ref = reference_order(self, old)
            mapped = [VIRTUAL if (x == VIRTUAL or x not in remap)
                      else remap[x] for x in old_ref]
            new_ref = reference_order(out, remap[old])
            out.atoms[remap[old]].parity = map_parity(p, mapped, new_ref)
        # ez is defined in the reference-substituent convention; transfer
        # after ALL bonds exist (the convention reads the new adjacency)
        # since remapping may change which substituent is lowest-index.
        if ez_transfer:
            from .ez import reference_substituents, set_ez_from_pair
            for old_bi, bi, ez in ez_transfer:
                ref = reference_substituents(self, old_bi)
                if ref is not None and ref[0] in remap and ref[1] in remap:
                    set_ez_from_pair(out, bi, remap[ref[0]],
                                     remap[ref[1]], ez)
        out.assign_implicit_hydrogens()
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"Mol(atoms={self.num_atoms}, bonds={self.num_bonds})"
