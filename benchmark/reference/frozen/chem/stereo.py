"""Tetrahedral stereochemistry: parity bookkeeping, wedge perception.

Fills the role RDKit plays for the reference pipeline's isomeric SMILES
(reference src/generate_smiles.py:117 ``MolToSmiles(isomericSmiles
=True)`` and MolFromMolBlock's wedge perception): tetrahedral ``@``/
``@@`` tags parsed from and emitted into SMILES, and parity assignment
from 2-D coordinates + wedge/hash bond annotations.

Conventions
-----------
``Atom.parity`` stores chirality in a *reference neighbor order*:
neighbors sorted by atom index, with the implicit hydrogen (or lone
pair) as a virtual neighbor in the LAST position.

  parity 1  ('@'):  looking from the first reference neighbor toward
                    the center, the remaining reference neighbors run
                    anticlockwise
  parity 2  ('@@'): clockwise
  parity 0: no stereo information

Any other neighbor ordering (a SMILES emission order, a parse order)
maps to/from the reference order by permutation sign: an odd
permutation flips the tag.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .mol import Mol, STEREO_HASH, STEREO_WEDGE

VIRTUAL = -1   # implicit H / lone pair placeholder in neighbor orders


def perm_parity(values: Sequence[int]) -> int:
    """0 for even permutations, 1 for odd — inversion-count parity of a
    sequence of unique comparable values."""
    v = list(values)
    n = len(v)
    inv = 0
    for i in range(n):
        for j in range(i + 1, n):
            if v[j] < v[i]:
                inv += 1
    return inv & 1


def reference_order(mol: Mol, idx: int) -> List[int]:
    """Reference neighbor order: atom indices ascending, virtual last
    when the site has fewer than four explicit neighbors."""
    nbrs = sorted(mol.neighbors(idx))
    if len(nbrs) < 4:
        nbrs.append(VIRTUAL)
    return nbrs


def map_parity(tag: int, from_order: Sequence[int],
               to_order: Sequence[int]) -> int:
    """Re-express a tag given in ``from_order`` into ``to_order``."""
    if tag == 0:
        return 0
    if len(from_order) != len(to_order) or \
            set(from_order) != set(to_order):
        return 0
    # permutation taking from_order -> to_order
    perm = [from_order.index(x) for x in to_order]
    if perm_parity(perm):
        return 3 - tag
    return tag


def parity_from_positions(center: Sequence[float],
                          ordered: Sequence[Optional[Sequence[float]]]
                          ) -> int:
    """Tag for neighbors listed in a given order with 3-D positions.

    ``ordered`` holds 3 or 4 positions; a single None entry (virtual
    neighbor) must be LAST. Returns 1 ('@' — anticlockwise from the
    first listed neighbor), 2, or 0 when the geometry is degenerate.
    """
    pts = [p for p in ordered if p is not None]
    if len(pts) < 3:
        return 0
    # Origin: the 4th neighbor when all four are explicit, else the
    # center (standing in for the implicit H / lone pair, which sits at
    # the center's depth). Using the 4th point — not the center — for
    # 4-neighbor sites makes the tag a true antisymmetric function of
    # the neighbor tuple: the old center-based triple product of the
    # first three ignored the 4th neighbor entirely and returned 0
    # (degenerate) whenever the wedge-lifted neighbor sorted last in the
    # reference order — silently dropping GT parities that the decoder
    # (different atom indexing) then assigned, a GT/decode asymmetry.
    origin = pts[3] if len(pts) >= 4 else center
    u = [[p[k] - origin[k] for k in range(3)] for p in pts[:3]]
    # triple product u1 . (u2 x u3)
    t = (u[0][0] * (u[1][1] * u[2][2] - u[1][2] * u[2][1])
         - u[0][1] * (u[1][0] * u[2][2] - u[1][2] * u[2][0])
         + u[0][2] * (u[1][0] * u[2][1] - u[1][1] * u[2][0]))
    # Scale-aware degeneracy threshold: z offsets are O(1) flags while
    # the in-plane coordinates carry the unit (pixels, grid cells, or
    # MolBlock units after the /60 transform with %.4f rounding), so a
    # configuration that is exactly degenerate in one unit must stay
    # degenerate after a linear rescale + format rounding. 1e-2 of the
    # squared max in-plane magnitude clears the rounding noise while
    # staying far below any genuine half-cell area.
    m = max(abs(v) for row in u for v in row[:2])
    if abs(t) < max(1e-2 * m * m, 1e-12):
        return 0
    return 1 if t > 0 else 2


def assign_parities_from_wedges(mol: Mol) -> int:
    """Set Atom.parity from 2-D coordinates + wedge/hash bonds.

    A wedge (hash) bond with its narrow end at atom ``a`` lifts the far
    atom toward (away from) the viewer — the RDKit MolFromMolBlock
    perception the reference relies on. Returns the number of centers
    assigned.
    """
    assigned = 0
    for idx in range(mol.num_atoms):
        a = mol.atoms[idx]
        nbrs = mol.neighbors(idx)
        if not (3 <= len(nbrs) <= 4) or a.aromatic:
            continue
        # Tetrahedral centers are sp3: every bond single, none aromatic.
        if any(b.order != 1 or b.aromatic for b in mol.bonds_of(idx)):
            continue
        # z offsets from wedges whose narrow end is this atom.
        z = {}
        any_wedge = False
        for b in mol.bonds_of(idx):
            j = b.other(idx)
            if b.stereo == STEREO_WEDGE and b.a == idx:
                z[j] = 1.0
                any_wedge = True
            elif b.stereo == STEREO_HASH and b.a == idx:
                z[j] = -1.0
                any_wedge = True
            else:
                z[j] = 0.0
        if not any_wedge:
            continue
        order = reference_order(mol, idx)
        positions: List[Optional[Tuple[float, float, float]]] = []
        for nb in order:
            if nb == VIRTUAL:
                positions.append(None)
            else:
                nba = mol.atoms[nb]
                positions.append((nba.x, nba.y, z[nb]))
        tag = parity_from_positions((a.x, a.y, 0.0), positions)
        if tag:
            a.parity = tag
            assigned += 1
    return assigned


def clear_parities(mol: Mol) -> None:
    for a in mol.atoms:
        a.parity = 0


def _atom_descriptor(mol: Mol, idx: int, ranks) -> int:
    """Index-invariant descriptor of a tagged center under a rank
    partition: the parity re-expressed in the neighbor order sorted by
    rank. Defined (nonzero) only when the neighbor ranks are distinct."""
    p = mol.atoms[idx].parity
    if not p:
        return 0
    nbrs = mol.neighbors(idx)
    rs = [ranks[n] for n in nbrs]
    if len(set(rs)) != len(rs):
        return 0
    target = sorted(nbrs, key=lambda n: ranks[n])
    if len(target) < 4:
        target.append(VIRTUAL)
    return map_parity(p, reference_order(mol, idx), target)


def _ez_descriptor(mol: Mol, bi: int, ranks) -> int:
    """Canonical cis/trans descriptor of a tagged double bond under a
    rank partition: the relation between the highest-ranked substituent
    on each end. 0 when either end's substituents tie."""
    from .ez import ez_for_pair
    b = mol.bonds[bi]
    if not b.ez:
        return 0
    picks = []
    for end, other in ((b.a, b.b), (b.b, b.a)):
        subs = [n for n in mol.neighbors(end) if n != other]
        rs = [ranks[n] for n in subs]
        if len(set(rs)) != len(rs):
            return 0
        picks.append(max(subs, key=lambda n: ranks[n]))
    return ez_for_pair(mol, bi, picks[0], picks[1])


def _stereo_refined_ranks(mol: Mol):
    """Canonical ranks iteratively refined with stereo descriptors
    (the CIP/Razinger loop): descriptors defined under the current
    partition split constitutionally-equivalent-but-stereo-different
    branches, which can define further descriptors, to a fixpoint."""
    from .smiles import _adjacency, _refine, canonical_ranks
    n = mol.num_atoms
    adj = _adjacency(mol)
    ranks = canonical_ranks(mol, adj)
    while True:
        a_desc = [_atom_descriptor(mol, i, ranks) for i in range(n)]
        e_desc = [[] for _ in range(n)]
        for bi, b in enumerate(mol.bonds):
            d = _ez_descriptor(mol, bi, ranks)
            if d:
                e_desc[b.a].append(d)
                e_desc[b.b].append(d)
        inv = [(ranks[i], a_desc[i], tuple(sorted(e_desc[i])))
               for i in range(n)]
        order = sorted(range(n), key=lambda i: inv[i])
        new_ranks = [0] * n
        r = 0
        for j, i in enumerate(order):
            if j > 0 and inv[i] != inv[order[j - 1]]:
                r = j
            new_ranks[i] = r
        new_ranks = _refine(mol, new_ranks, adj)
        if new_ranks == ranks:
            return ranks
        ranks = new_ranks


def prune_nonstereogenic(mol: Mol) -> int:
    """Clear stereo tags on non-stereogenic sites (RDKit's
    AssignStereochemistry cleanup role): a tetrahedral center with two
    equivalent substituents, or a double bond whose end carries two
    equivalent substituents, is not a stereocenter.

    Equivalence is judged by canonical ranks refined with stereo
    descriptors (_stereo_refined_ranks), so stereo-DEPENDENT (para /
    pseudoasymmetric) centers survive: in (2R,4S)-2,3,4-
    trihydroxyglutaric acid the C3 branches are constitutionally
    identical but R vs S, and C3's tag is kept (CIP r/s), while the
    (2R,4R) form's C3 tag is cleared. Clearing can cascade — a cleared
    tag removes a descriptor another center depended on — so the whole
    procedure repeats to a fixpoint. Returns the number of tags
    cleared."""
    if (not any(a.parity for a in mol.atoms)
            and not any(b.ez for b in mol.bonds)):
        return 0  # nothing to prune; skip the refinement loops entirely
    cleared = 0
    while True:
        ranks = _stereo_refined_ranks(mol)
        changed = False
        for idx, a in enumerate(mol.atoms):
            if not a.parity:
                continue
            nbr_ranks = [ranks[n] for n in mol.neighbors(idx)]
            if len(set(nbr_ranks)) != len(nbr_ranks):
                a.parity = 0
                cleared += 1
                changed = True
        for b in mol.bonds:
            if not b.ez:
                continue
            ok = True
            for end, excl in ((b.a, b.b), (b.b, b.a)):
                subs = [ranks[n] for n in mol.neighbors(end) if n != excl]
                if len(set(subs)) != len(subs):
                    ok = False
            if not ok:
                b.ez = 0
                cleared += 1
                changed = True
        if not changed:
            return cleared
