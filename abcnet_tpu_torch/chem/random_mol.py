"""Random drug-like molecule generation.

The reference pipeline consumes ChEMBL SMILES from a CSV
(reference rdkit_img_generate.py:221). That corpus is not available
here, so the framework generates its own ChEMBL-like molecules: ring
systems and functional groups drawn from a curated fragment pool,
stitched together under valence constraints, with charged groups at
realistic rates. Ground truth is the generator's own graph — no parsing
round-trip needed — and the canonical SMILES comes from the chem core.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

from . import periodic
from .mol import Atom, Mol
from .smiles import from_smiles

# Ring-system templates, parsed once. Weights roughly follow drug-like
# frequency (benzene dominates; fused systems rarer).
_RING_TEMPLATES: List[Tuple[str, float]] = [
    ("c1ccccc1", 8.0),        # benzene
    ("c1ccncc1", 2.5),        # pyridine
    ("c1cncnc1", 1.0),        # pyrimidine
    ("c1cc[nH]c1", 0.8),      # pyrrole
    ("c1c[nH]cn1", 0.8),      # imidazole
    ("c1ccoc1", 0.6),         # furan
    ("c1ccsc1", 0.7),         # thiophene
    ("c1cn[nH]c1", 0.5),      # pyrazole
    ("c1csc(n1)", 0.0),       # placeholder (invalid), pruned below
    ("C1CCCCC1", 2.0),        # cyclohexane
    ("C1CCCC1", 1.0),         # cyclopentane
    ("C1CCNCC1", 1.5),        # piperidine
    ("C1CNCCN1", 1.2),        # piperazine
    ("C1COCCN1", 1.0),        # morpholine
    ("C1CCOC1", 0.6),         # tetrahydrofuran
    ("C1CC1", 0.5),           # cyclopropane
    ("c1ccc2ccccc2c1", 0.8),  # naphthalene
    ("c1ccc2[nH]ccc2c1", 0.6),  # indole
    ("c1ccc2ncccc2c1", 0.6),  # quinoline
    ("c1ccc2[nH]cnc2c1", 0.4),  # benzimidazole
    ("c1ccc2occc2c1", 0.3),   # benzofuran
    ("c1ccc2sccc2c1", 0.3),   # benzothiophene
    ("C1CCC2(CC1)CCCC2", 0.2),  # spiro
]

# Substituent templates: (smiles, attach_atom_index, weight).
_SUBSTITUENTS: List[Tuple[str, int, float]] = [
    ("C", 0, 8.0),            # methyl
    ("CC", 0, 2.0),           # ethyl
    ("C(C)C", 0, 1.0),        # isopropyl
    ("F", 0, 2.5),
    ("Cl", 0, 2.0),
    ("Br", 0, 0.8),
    ("I", 0, 0.25),
    ("O", 0, 2.5),            # hydroxyl
    ("OC", 0, 2.0),           # methoxy
    ("N", 0, 1.5),            # amino
    ("N(C)C", 0, 0.8),        # dimethylamino
    ("C#N", 0, 0.8),          # nitrile
    ("C(F)(F)F", 0, 1.0),     # trifluoromethyl
    ("[N+](=O)[O-]", 0, 0.6),  # nitro
    ("C(=O)O", 0, 1.2),       # carboxylic acid
    ("C(=O)[O-]", 0, 0.25),   # carboxylate
    ("C(=O)N", 0, 1.0),       # primary amide
    ("C(=O)C", 0, 0.8),       # acetyl
    ("C=O", 0, 0.4),          # aldehyde
    ("OC(=O)C", 0, 0.6),      # acetoxy
    ("S", 0, 0.4),            # thiol
    ("SC", 0, 0.4),           # thiomethyl
    ("S(=O)(=O)C", 0, 0.5),   # methylsulfonyl
    ("S(=O)(=O)N", 0, 0.4),   # sulfonamide
    ("[N+](C)(C)C", 0, 0.15),  # quaternary ammonium
    ("B(O)O", 0, 0.15),       # boronic acid
    ("[Si](C)(C)C", 0, 0.1),  # trimethylsilyl
    ("[Se]C", 0, 0.05),       # selenide
    ("C=C", 0, 0.5),          # vinyl
    ("C#C", 0, 0.3),          # ethynyl
]

# Linkers joining two fragments: (smiles or None for direct bond,
# attach_head, attach_tail, weight).
_LINKERS: List[Tuple[Optional[str], int, int, float]] = [
    (None, 0, 0, 3.0),        # direct single bond
    ("C", 0, 0, 2.0),         # methylene
    ("CC", 0, 1, 1.0),        # ethylene
    ("O", 0, 0, 1.2),         # ether
    ("N", 0, 0, 1.0),         # secondary amine
    ("C(=O)N", 0, 2, 1.5),    # amide
    ("C(=O)O", 0, 2, 0.7),    # ester
    ("C(=O)", 0, 0, 0.5),     # ketone
    ("S(=O)(=O)", 0, 0, 0.4),  # sulfone
    ("OC", 0, 1, 0.6),        # oxymethylene
    ("C=C", 0, 1, 0.4),       # alkene
    ("NC(=O)C", 0, 3, 0.4),   # reverse amide + methylene
]


def _parse_pool():
    rings = []
    for smi, w in _RING_TEMPLATES:
        if w <= 0:
            continue
        try:
            m = from_smiles(smi)
        except Exception:
            continue
        rings.append((m, w))
    subs = []
    for smi, at, w in _SUBSTITUENTS:
        try:
            m = from_smiles(smi)
        except Exception:
            continue
        subs.append((m, at, w))
    links = []
    for smi, head, tail, w in _LINKERS:
        if smi is None:
            links.append((None, head, tail, w))
            continue
        try:
            m = from_smiles(smi)
        except Exception:
            continue
        links.append((m, head, tail, w))
    return rings, subs, links


_POOL = None


def _pool():
    global _POOL
    if _POOL is None:
        _POOL = _parse_pool()
    return _POOL


def _weighted_choice(rng: random.Random, items, weight_idx: int):
    total = sum(it[weight_idx] for it in items)
    r = rng.random() * total
    acc = 0.0
    for it in items:
        acc += it[weight_idx]
        if r <= acc:
            return it
    return items[-1]


def free_valence(mol: Mol, idx: int) -> int:
    """Open bonding slots at an atom (standard-valence model)."""
    atom = mol.atoms[idx]
    order_sum = mol.bond_order_sum(idx)
    pinned = atom.num_explicit_hs or 0
    occupied = order_sum + pinned
    for v in periodic.default_valences(atom.symbol, atom.charge):
        if occupied <= v:
            return v - order_sum - pinned if atom.num_explicit_hs is not None \
                else v - order_sum
    return 0


def _graft(dst: Mol, src: Mol) -> List[int]:
    """Copy ``src`` into ``dst``; return new indices of src's atoms."""
    mapping = []
    for a in src.atoms:
        mapping.append(dst.add_atom(
            Atom(a.symbol, a.charge, a.num_explicit_hs, a.aromatic,
                 a.implicit_hs, isotope=a.isotope)))
    for b in src.bonds:
        dst.add_bond(mapping[b.a], mapping[b.b], b.order, b.aromatic,
                     b.stereo)
    return mapping


def _attachment_sites(mol: Mol, rng: random.Random,
                      prefer_carbon: bool = True) -> List[int]:
    sites = []
    for i in range(mol.num_atoms):
        fv = free_valence(mol, i)
        if fv >= 1:
            # Avoid substituting on halogens or pinned-charge oxygens.
            sym = mol.atoms[i].symbol
            if sym in ("F", "Cl", "Br", "I"):
                continue
            if mol.atoms[i].num_explicit_hs is not None and \
                    free_valence(mol, i) < 1:
                continue
            sites.append(i)
    return sites


def random_molecule(rng: random.Random,
                    min_atoms: int = 8,
                    max_atoms: int = 40) -> Mol:
    """Generate one random drug-like molecule as a sanitized Mol."""
    rings, subs, links = _pool()
    mol = Mol()

    n_frag = rng.choices([1, 2, 3, 4], weights=[2, 4, 3, 1])[0]
    frag_roots: List[List[int]] = []

    for k in range(n_frag):
        if mol.num_atoms >= max_atoms - 5:
            break
        frag, w = _weighted_choice(rng, rings, 1)
        if mol.num_atoms + frag.num_atoms > max_atoms:
            break
        mapping = _graft(mol, frag)
        frag_roots.append(mapping)
        if k > 0:
            # Connect to a previous fragment through a random linker.
            prev = frag_roots[rng.randrange(len(frag_roots) - 1)]
            prev_sites = [i for i in prev if free_valence(mol, i) >= 1]
            new_sites = [i for i in mapping if free_valence(mol, i) >= 1]
            if not prev_sites or not new_sites:
                continue
            a = rng.choice(prev_sites)
            b = rng.choice(new_sites)
            link, head, tail, w = _weighted_choice(rng, links, 3)
            if link is None:
                mol.add_bond(a, b, 1)
            else:
                lmap = _graft(mol, link)
                mol.add_bond(a, lmap[head], 1)
                mol.add_bond(lmap[tail], b, 1)

    if mol.num_atoms == 0:
        frag, _ = _weighted_choice(rng, rings, 1)
        frag_roots.append(_graft(mol, frag))

    # Decorate with substituents until the size budget is reached.
    target = rng.randint(min_atoms, max_atoms)
    attempts = 0
    while mol.num_atoms < target and attempts < 30:
        attempts += 1
        sites = _attachment_sites(mol, rng)
        if not sites:
            break
        site = rng.choice(sites)
        sub, at, w = _weighted_choice(rng, subs, 2)
        if mol.num_atoms + sub.num_atoms > max_atoms:
            continue
        smap = _graft(mol, sub)
        mol.add_bond(site, smap[at], 1)

    mol.assign_implicit_hydrogens()
    return mol
