"""Tautomer enumeration + canonicalization.

Standalone replacement for the RDKit MolStandardize call the reference
scores with (``canonicalize_tautomer_smiles``,
reference src/cal_acc.py:13-27, src/img2smiles3.py:321-325): a
miniature of RDKit's TautomerEnumerator — enumerate 1,3 H-shifts over
conjugated donor/acceptor paths, score candidates (aromatic rings
dominate, then carbonyls), pick the max score with a lexicographic
canonical-SMILES tiebreak. Covers the tautomer classes the synthetic
pipeline actually produces (keto/enol, amide/iminol, azole NH shifts);
exotic RDKit rules (phosphorus, 1,5-shifts across heteroaromatics) are
out of scope and score identically on both sides of a comparison.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from .aromaticity import (apply_kekule_matching, kekule_matchings,
                          perceive_aromaticity)
from .mol import Mol
from .smiles import from_smiles, to_smiles

MAX_STATES = 200
MAX_DEPTH = 6

# Atoms allowed as H donors/acceptors in a shift.
_DA = {"C", "N", "O", "S"}


def _hyperoxo(mol: Mol, i: int) -> bool:
    """Sulfonyl/sulfinyl/nitro/phosphoryl-like center: S/N/P carrying
    double-bonded oxygen. RDKit's TautomerEnumerator never shifts
    through these (its transforms are element-pattern-scoped); allowing
    them fabricates hypervalent 'enol' forms like C=S(O)(O) from
    sulfones, which the scorer may then prefer — the dominant class of
    measured metric-1 divergence before this guard."""
    a = mol.atoms[i]
    if a.symbol not in ("S", "N", "P"):
        return False
    for bi in mol.bond_indices_of(i):
        b = mol.bonds[bi]
        if b.order == 2 and mol.atoms[b.other(i)].symbol == "O" \
                and len(mol.bond_indices_of(i)) >= 3:
            return True
    return False


def _shift_moves(mol: Mol) -> List[Tuple[int, int, int, int, int]]:
    """All 1,3 H-shift moves (donor, b1, mid, b2, acceptor):
    donor(-H) -b1(single)- mid =b2(double)= acceptor  ->  H moves to
    acceptor, b1 becomes double, b2 single. Pure carbon-to-carbon
    shifts (alkene walks) are not tautomer moves and are skipped, as
    are moves through hyper-oxygenated S/N/P centers (see _hyperoxo)."""
    moves = []
    for d in range(mol.num_atoms):
        ad = mol.atoms[d]
        if ad.symbol not in _DA or ad.total_hs <= 0 or ad.aromatic:
            continue
        if _hyperoxo(mol, d):
            continue
        for b1 in mol.bond_indices_of(d):
            bond1 = mol.bonds[b1]
            if bond1.order != 1 or bond1.aromatic:
                continue
            m = bond1.other(d)
            if _hyperoxo(mol, m):
                continue
            for b2 in mol.bond_indices_of(m):
                bond2 = mol.bonds[b2]
                if b2 == b1 or bond2.order != 2 or bond2.aromatic:
                    continue
                a = bond2.other(m)
                aa = mol.atoms[a]
                if aa.symbol not in _DA:
                    continue
                if ad.symbol == "C" and aa.symbol == "C":
                    continue
                if _hyperoxo(mol, a):
                    continue
                moves.append((d, b1, m, b2, a))
    return moves


def _apply(mol: Mol, move) -> Mol:
    d, b1, m, b2, a = move
    out = mol.copy()
    out.bonds[b1].order = 2
    out.bonds[b2].order = 1
    out.atoms[d].num_explicit_hs = mol.atoms[d].total_hs - 1
    out.atoms[a].num_explicit_hs = mol.atoms[a].total_hs + 1
    # Pin every H count so sanitize cannot re-derive a different one.
    for i, atom in enumerate(out.atoms):
        if atom.num_explicit_hs is None:
            atom.num_explicit_hs = mol.atoms[i].total_hs
    for bond in out.bonds:
        bond.aromatic = False
    for atom in out.atoms:
        atom.aromatic = False
    try:
        perceive_aromaticity(out)
    except Exception:
        pass
    return out


def _score(mol: Mol) -> int:
    """RDKit-style preference: aromatic rings >> carbonyl-like bonds."""
    score = 0
    seen_aromatic_rings = 0
    for ring in mol.sssr():
        if all(mol.atoms[i].aromatic for i in ring):
            seen_aromatic_rings += 1
    score += 100 * seen_aromatic_rings
    for b in mol.bonds:
        if b.order == 2 and not b.aromatic:
            syms = {mol.atoms[b.a].symbol, mol.atoms[b.b].symbol}
            if syms == {"C", "O"}:
                score += 4          # carbonyl beats enol
            elif syms == {"C", "N"}:
                score += 1
            elif syms == {"C", "S"}:
                score += 2
    return score


def canonical_tautomer(mol: Mol) -> Mol:
    """Enumerate tautomers (bounded BFS) and return the canonical one."""
    best, _ = _enumerate(mol)
    return best if best is not None else mol


def enumerate_tautomer_smiles(mol: Mol) -> Set[str]:
    """All tautomer canonical-SMILES visited by the bounded BFS —
    the measurement surface for bounding metric-1 divergence
    (scripts/tautomer_divergence.py)."""
    _, seen = _enumerate(mol)
    return seen


def _enumerate(mol: Mol) -> Tuple[Optional[Mol], Set[str]]:
    try:
        start = mol.copy()
        perceive_aromaticity(start)
    except Exception:
        start = mol
    best = (None, None)  # (key, mol)

    seen: Set[str] = set()
    queue: List[Tuple[Mol, int]] = [(start, 0)]
    while queue and len(seen) < MAX_STATES:
        cur, depth = queue.pop(0)
        try:
            smi = to_smiles(cur, canonical=True)
        except Exception:
            continue
        if smi in seen:
            continue
        seen.add(smi)
        key = (-_score(cur), smi)
        if best[0] is None or key < best[0]:
            best = (key, cur)
        if depth >= MAX_DEPTH:
            continue
        # Work on kekulized copies so ring bonds expose explicit orders.
        # Clearing the aromatic flags (only when kekulization succeeded)
        # lets _shift_moves walk INTO former-aromatic rings — this is
        # what realizes azole NH annular tautomerism (imidazole N1-H ->
        # N3-H is a 1,3-shift over the kekule structure) and lets the
        # enumerator visit e.g. phenol's cyclohexadienone form, which
        # _score then rejects (-100 for the lost aromatic ring).
        # ALL kekule variants are expanded, not just the first: e.g.
        # 2-hydroxypyridine -> 2-pyridone needs the C2=N1 structure,
        # which the deterministic matching may or may not pick.
        works: List[Mol] = []
        variants = []
        try:
            variants = kekule_matchings(cur, limit=4)
        except Exception:
            pass
        if variants:
            for matching in variants:
                work = cur.copy()
                apply_kekule_matching(work, matching)
                for atom in work.atoms:
                    atom.aromatic = False
                for bond in work.bonds:
                    bond.aromatic = False
                works.append(work)
        else:
            works.append(cur)
        for work in works:
            for move in _shift_moves(work):
                queue.append((_apply(work, move), depth + 1))
    return best[1], seen


def canonicalize_tautomer_smiles(smiles: str) -> Optional[str]:
    """SMILES -> canonical-tautomer canonical SMILES (cal_acc.py:13-27)."""
    try:
        mol = from_smiles(smiles)
        return to_smiles(canonical_tautomer(mol), canonical=True)
    except Exception:
        return None
