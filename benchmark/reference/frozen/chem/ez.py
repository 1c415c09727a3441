"""Cis/trans (E/Z) double-bond stereo: representation and perception.

Complements chem/stereo.py's tetrahedral parities; together they cover
the isomeric-SMILES surface RDKit provides to the reference
(``MolToSmiles(isomericSmiles=True)``).

Representation
--------------
``Bond.ez`` on a double bond a=b: 0 none; CIS (1) / TRANS (2) defined
for the *reference substituent pair* — the lowest-index neighbor of
``a`` (excluding ``b``) and the lowest-index neighbor of ``b``
(excluding ``a``). Any other substituent pair flips accordingly (each
end has at most two substituents; switching one end's substituent flips
cis<->trans).

SMILES ``/`` ``\\`` semantics: a directional single bond written
``p/q`` "rises" from p to q. For a double bond a=b with directional
neighbors x-a and b-y, normalizing both to neighbor->atom orientation:
equal directions put the substituents on the same side (CIS), opposite
directions mean TRANS. (Check: F/C=C/F, trans-difluoroethene: F->C
rises, F'->C' falls — opposite.)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .mol import Bond, Mol

EZ_NONE = 0
EZ_CIS = 1
EZ_TRANS = 2


def reference_substituents(mol: Mol, bi: int) -> Optional[Tuple[int, int]]:
    """Lowest-index substituent on each end of double bond ``bi``."""
    bond = mol.bonds[bi]
    xs = [n for n in mol.neighbors(bond.a) if n != bond.b]
    ys = [n for n in mol.neighbors(bond.b) if n != bond.a]
    if not xs or not ys:
        return None
    return min(xs), min(ys)


def ez_for_pair(mol: Mol, bi: int, x: int, y: int) -> int:
    """Bond.ez re-expressed for substituent pair (x on a-side, y on
    b-side): flips once per non-reference substituent."""
    bond = mol.bonds[bi]
    if bond.ez == EZ_NONE:
        return EZ_NONE
    ref = reference_substituents(mol, bi)
    if ref is None:
        return EZ_NONE
    flips = int(x != ref[0]) + int(y != ref[1])
    return bond.ez if flips % 2 == 0 else 3 - bond.ez


def set_ez_from_pair(mol: Mol, bi: int, x: int, y: int, rel: int) -> None:
    """Store Bond.ez given the relation observed for pair (x, y)."""
    ref = reference_substituents(mol, bi)
    if ref is None or rel == EZ_NONE:
        return
    flips = int(x != ref[0]) + int(y != ref[1])
    mol.bonds[bi].ez = rel if flips % 2 == 0 else 3 - rel


def assign_ez_from_coords(mol: Mol) -> int:
    """Perceive cis/trans for acyclic, non-aromatic double bonds from
    2-D coordinates (the reference gets this from RDKit's MolBlock
    perception). Returns the number of bonds assigned."""
    ring = mol.ring_bond_flags()
    assigned = 0
    for bi, bond in enumerate(mol.bonds):
        if bond.order != 2 or bond.aromatic or ring[bi]:
            continue
        a, b = mol.atoms[bond.a], mol.atoms[bond.b]
        xs = [n for n in mol.neighbors(bond.a) if n != bond.b]
        ys = [n for n in mol.neighbors(bond.b) if n != bond.a]
        if not xs or not ys:
            continue
        dx, dy = b.x - a.x, b.y - a.y

        def _side(n, end):
            p = mol.atoms[n]
            return dx * (p.y - end.y) - dy * (p.x - end.x)

        # The assignment decision must be PAIR-INDEPENDENT: ground
        # truth and decode may index atoms differently and therefore
        # evaluate different reference substituents, so every
        # substituent's geometry must be trustworthy before a tag is
        # written. Scale-aware threshold (see
        # stereo.parity_from_positions): degenerate-in-grid
        # configurations must not become assigned from MolBlock %.4f
        # rounding noise after the /60 transform.
        s_a = [(n, _side(n, a)) for n in xs]
        s_b = [(n, _side(n, b)) for n in ys]
        m = max([abs(dx), abs(dy)]
                + [abs(mol.atoms[n].x - a.x) for n in xs]
                + [abs(mol.atoms[n].y - a.y) for n in xs]
                + [abs(mol.atoms[n].x - b.x) for n in ys]
                + [abs(mol.atoms[n].y - b.y) for n in ys])
        thr = max(1e-2 * m * m, 1e-12)
        if any(abs(s) < thr for _, s in s_a + s_b):
            continue
        # Same-end substituents must straddle the bond axis; stride-4
        # quantization can squeeze both onto one side (observed: the
        # two sides then evaluate different pairs and write
        # CONTRADICTORY isomers — the residual 'stereo~' ceiling
        # bucket). Such drawings carry no trustworthy E/Z information.
        if len(s_a) == 2 and (s_a[0][1] > 0) == (s_a[1][1] > 0):
            continue
        if len(s_b) == 2 and (s_b[0][1] > 0) == (s_b[1][1] > 0):
            continue
        x, sx = min(s_a)
        y, sy = min(s_b)
        rel = EZ_CIS if (sx > 0) == (sy > 0) else EZ_TRANS
        set_ez_from_pair(mol, bi, x, y, rel)
        assigned += 1
    return assigned


def clear_ez(mol: Mol) -> None:
    for b in mol.bonds:
        b.ez = EZ_NONE
