"""Aromaticity perception and kekulization.

Replaces the aromatic handling the reference gets for free from RDKit
(`Chem.Kekulize` in reference rdkit_img_generate.py:62,
`MolFromMolBlock` aromatic perception in generate_smiles.py:115).

Model: a simplified RDKit-style electron-counting Hückel rule over the
relevant-ring basis. Atoms contribute pi electrons as

  * atom with a double bond to another candidate ring atom ........ 1
  * atom with an exocyclic double bond (quinoid carbon, c=O) ...... 0
  * N/P/As with three sigma connections (incl. H) ................. 2
  * O/S/Se/Te ..................................................... 2
  * C- (cyclopentadienyl anion) ................................... 2
  * C+ (tropylium) ................................................ 0

and a ring is aromatic when every member is sp2-capable and the electron
count satisfies 4n+2.
"""

from __future__ import annotations

from typing import List, Optional, Set

from .mol import Mol, MolError


def _pi_contribution(mol: Mol, idx: int, candidate: Set[int]) -> Optional[int]:
    """Pi electrons the atom donates to an aromatic system, or None if the
    atom cannot sit in an aromatic ring."""
    atom = mol.atoms[idx]
    sym = atom.symbol
    double_partner = None
    has_triple = False
    for bond in mol.bonds_of(idx):
        if bond.order == 2:
            double_partner = bond.other(idx)
        elif bond.order == 3:
            has_triple = True
    if has_triple:
        return None
    if double_partner is not None:
        return 1 if double_partner in candidate else 0
    # No double bond: lone-pair donors.
    connections = mol.degree(idx) + _h_count(mol, idx)
    if sym in ("O", "S", "Se", "Te"):
        return 2 if atom.charge == 0 else (1 if atom.charge == 1 else 2)
    if sym in ("N", "P", "As"):
        # Pyrrole-type: three sigma connections and no double bond.
        if connections == 3 + (1 if atom.charge == 1 else 0) - \
                (1 if atom.charge == -1 else 0):
            return 2
        if atom.charge == -1 and connections == 2:
            return 2
        return None
    if sym == "C":
        if atom.charge == -1:
            return 2
        if atom.charge == 1:
            return 0
        return None
    if sym == "B":
        return 0
    return None


def _h_count(mol: Mol, idx: int) -> int:
    atom = mol.atoms[idx]
    if atom.num_explicit_hs is not None:
        return atom.num_explicit_hs
    return atom.implicit_hs


def perceive_aromaticity(mol: Mol) -> None:
    """Set aromatic flags on atoms/bonds of a kekulized molecule.

    Requires implicit hydrogens to be assigned (or explicit H counts set):
    call after ``assign_implicit_hydrogens``.
    """
    for atom in mol.atoms:
        atom.aromatic = False
    for bond in mol.bonds:
        bond.aromatic = False

    rings = mol.sssr()
    rings = [r for r in rings if 5 <= len(r) <= 7]
    if not rings:
        return
    candidate: Set[int] = set()
    for ring in rings:
        candidate.update(ring)

    # Iterate: aromatizing one ring can change nothing in this simple model,
    # but the candidate set restricts double-bond partners to ring atoms.
    changed = True
    aromatic_rings: List[List[int]] = []
    ring_done = [False] * len(rings)
    while changed:
        changed = False
        for ri, ring in enumerate(rings):
            if ring_done[ri]:
                continue
            total = 0
            ok = True
            for idx in ring:
                contrib = _pi_contribution(mol, idx, candidate)
                if contrib is None:
                    ok = False
                    break
                total += contrib
            if ok and total % 4 == 2:
                ring_done[ri] = True
                aromatic_rings.append(ring)
                changed = True

    for ring in aromatic_rings:
        ring_set = set(ring)
        for idx in ring:
            mol.atoms[idx].aromatic = True
        for idx in ring:
            for bond in mol.bonds_of(idx):
                if bond.other(idx) in ring_set:
                    # Only flag bonds that lie on this ring's cycle.
                    pass
        n = len(ring)
        for i in range(n):
            a, b = ring[i], ring[(i + 1) % n]
            bond = mol.bond_between(a, b)
            if bond is not None:
                bond.aromatic = True


def kekulize(mol: Mol) -> None:
    """Assign alternating double bonds to aromatic systems.

    Aromatic atoms/bonds are those flagged ``aromatic`` (e.g. parsed from
    lowercase SMILES or MolBlock bond type 4). Bonds in the aromatic system
    keep their flag; their kekulized ``order`` is set to 1 or 2 such that
    every atom requiring a pi bond gets exactly one.
    """
    arom_bonds = [i for i, b in enumerate(mol.bonds) if b.aromatic]
    if not arom_bonds:
        return
    arom_atoms = sorted({a for i in arom_bonds
                         for a in (mol.bonds[i].a, mol.bonds[i].b)})

    # Which aromatic atoms need one double bond in the kekule structure?
    needs = {}
    for idx in arom_atoms:
        needs[idx] = _needs_pi_bond(mol, idx)

    # Reset aromatic bond orders to single, then match.
    for bi in arom_bonds:
        mol.bonds[bi].order = 1

    need_atoms = [a for a in arom_atoms if needs[a]]
    if not need_atoms:
        return

    # Perfect matching on the subgraph induced by need_atoms over aromatic
    # bonds, via deterministic backtracking (molecules are small).
    adj = {a: [] for a in need_atoms}
    need_set = set(need_atoms)
    for bi in arom_bonds:
        b = mol.bonds[bi]
        if b.a in need_set and b.b in need_set:
            adj[b.a].append((b.b, bi))
            adj[b.b].append((b.a, bi))

    matched = {}

    def backtrack(i: int) -> bool:
        while i < len(need_atoms) and need_atoms[i] in matched:
            i += 1
        if i >= len(need_atoms):
            return True
        v = need_atoms[i]
        for (u, bi) in adj[v]:
            if u in matched:
                continue
            matched[v] = (u, bi)
            matched[u] = (v, bi)
            if backtrack(i + 1):
                return True
            del matched[v]
            del matched[u]
        return False

    if not backtrack(0):
        raise MolError("kekulization failed: no valid alternating "
                       f"double-bond assignment ({len(need_atoms)} atoms)")

    done = set()
    for v, (u, bi) in matched.items():
        if bi in done:
            continue
        done.add(bi)
        mol.bonds[bi].order = 2


def kekule_matchings(mol: Mol, limit: int = 4):
    """Enumerate up to ``limit`` DISTINCT kekule assignments of the
    aromatic system, as lists of bond indices that receive order 2.

    kekulize() commits to the first perfect matching its backtracking
    finds; tautomer enumeration needs the alternatives too — e.g.
    2-hydroxypyridine's O-H can only 1,3-shift onto the ring N through
    the kekule structure with C2=N1, and whether the first matching has
    that bond is an accident of bond ordering. Returns [] when the
    molecule has no aromatic system.
    """
    arom_bonds = [i for i, b in enumerate(mol.bonds) if b.aromatic]
    if not arom_bonds:
        return []
    arom_atoms = sorted({a for i in arom_bonds
                         for a in (mol.bonds[i].a, mol.bonds[i].b)})
    need_atoms = [a for a in arom_atoms if _needs_pi_bond(mol, a)]
    if not need_atoms:
        return [[]]
    need_set = set(need_atoms)
    adj = {a: [] for a in need_atoms}
    for bi in arom_bonds:
        b = mol.bonds[bi]
        if b.a in need_set and b.b in need_set:
            adj[b.a].append((b.b, bi))
            adj[b.b].append((b.a, bi))

    out = []
    matched = {}

    def backtrack(i: int) -> bool:
        """Returns True when the enumeration hit ``limit``."""
        while i < len(need_atoms) and need_atoms[i] in matched:
            i += 1
        if i >= len(need_atoms):
            sol = sorted({bi for (_, bi) in matched.values()})
            if sol not in out:
                out.append(sol)
            return len(out) >= limit
        v = need_atoms[i]
        for (u, bi) in adj[v]:
            if u in matched:
                continue
            matched[v] = (u, bi)
            matched[u] = (v, bi)
            if backtrack(i + 1):
                return True
            del matched[v]
            del matched[u]
        return False

    backtrack(0)
    return out


def apply_kekule_matching(mol: Mol, matching) -> None:
    """Set aromatic-system bond orders from a kekule_matchings() entry
    (aromatic flags are left to the caller)."""
    ms = set(matching)
    for i, b in enumerate(mol.bonds):
        if b.aromatic:
            b.order = 2 if i in ms else 1


def _needs_pi_bond(mol: Mol, idx: int) -> bool:
    atom = mol.atoms[idx]
    sym = atom.symbol
    # Existing non-aromatic double bond (exocyclic quinoid) satisfies sp2.
    for bond in mol.bonds_of(idx):
        if not bond.aromatic and bond.order >= 2:
            return False
    if sym in ("O", "S", "Se", "Te"):
        return atom.charge == 1  # rare; neutral chalcogens donate lone pairs
    if sym in ("N", "P", "As"):
        target = 3 + atom.charge
        connections = mol.degree(idx) + _h_count_for_kekulize(mol, idx)
        return connections < target
    if sym == "C":
        if atom.charge != 0:
            return False
        target = 4
        connections = mol.degree(idx) + _h_count_for_kekulize(mol, idx)
        return connections < target
    if sym == "B":
        return False
    return False


def _h_count_for_kekulize(mol: Mol, idx: int) -> int:
    """H count used during kekulization.

    For bracket atoms the explicit H count decides pyrrole vs pyridine
    nitrogens. For organic-subset aromatic atoms without an explicit count
    the SMILES convention applies: aromatic C with two ring neighbors has
    one H; aromatic N has none unless written [nH].
    """
    atom = mol.atoms[idx]
    if atom.num_explicit_hs is not None:
        return atom.num_explicit_hs
    sym = atom.symbol
    deg = mol.degree(idx)
    if sym == "C" and atom.charge == 0:
        return max(0, 3 - deg)
    # Aromatic N/P written bare means pyridine-type (no H).
    return 0
