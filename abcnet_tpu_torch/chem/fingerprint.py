"""Morgan (ECFP-style) circular fingerprints and Dice similarity.

Standalone replacement for the scoring path the reference takes through
RDKit (``AllChem.GetMorganFingerprint(mol, 3)`` +
``DataStructs.DiceSimilarity``, reference src/cal_acc.py:38-40):
count-based circular fingerprints of radius 3 with hashed environment
identifiers, compared with the Dice coefficient over counts.
"""

from __future__ import annotations

from typing import Dict

from .mol import Mol


def _hash_tuple(t) -> int:
    # Deterministic 64-bit FNV-1a over the tuple's repr-free encoding.
    h = 0xCBF29CE484222325
    for v in t:
        for b in (int(v) & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"):
            h ^= b
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def morgan_fingerprint(mol: Mol, radius: int = 3) -> Dict[int, int]:
    """Counted Morgan fingerprint: environment hash -> count."""
    ring_atoms = mol.ring_atom_flags()
    n = mol.num_atoms
    # Initial atom invariants (ECFP-style).
    ids = []
    for i, a in enumerate(mol.atoms):
        ids.append(_hash_tuple((
            a.atomic_number,
            mol.degree(i),
            a.charge,
            a.total_hs,
            1 if a.aromatic else 0,
            1 if ring_atoms[i] else 0,
        )))

    counts: Dict[int, int] = {}
    # Radius 0 environments: every atom contributes (ECFP definition).
    for i in range(n):
        counts[ids[i]] = counts.get(ids[i], 0) + 1

    bond_key = [4 if b.aromatic else b.order for b in mol.bonds]
    # ECFP bond-set dedup (Rogers & Hahn 2010 §"duplicate removal",
    # matching RDKit's Morgan env dedup): an environment is identified by
    # the SET OF BONDS it covers; each distinct bond set contributes
    # exactly once across ALL radii. This both collapses symmetric
    # duplicates found at the same radius (ethane's two radius-1 envs are
    # the same single bond -> one contribution) and stops re-counting
    # environments that no longer grow (a whole-molecule env reached at
    # radius r is not counted again at r+1; an isolated atom never gains
    # bonds, so methane's fingerprint is exactly its radius-0 env).
    seen_envs: set = set()
    env_bonds = [frozenset() for _ in range(n)]
    for r in range(1, radius + 1):
        new_ids = list(ids)
        new_env_bonds = list(env_bonds)
        for i in range(n):
            nbrs = []
            bonds = set(env_bonds[i])
            for bi in mol.bond_indices_of(i):
                b = mol.bonds[bi]
                j = b.other(i)
                nbrs.append((bond_key[bi], ids[j]))
                bonds.add(bi)
                bonds |= env_bonds[j]
            nbrs.sort()
            flat = [r, ids[i]]
            for bk, nid in nbrs:
                flat.extend((bk, nid))
            new_ids[i] = _hash_tuple(tuple(flat))
            new_env_bonds[i] = frozenset(bonds)
        ids = new_ids
        env_bonds = new_env_bonds
        for i in range(n):
            key = env_bonds[i]
            if not key or key in seen_envs:
                continue
            seen_envs.add(key)
            counts[ids[i]] = counts.get(ids[i], 0) + 1
    return counts


def dice_similarity(fp1: Dict[int, int], fp2: Dict[int, int]) -> float:
    """Dice coefficient over counted fingerprints."""
    total1 = sum(fp1.values())
    total2 = sum(fp2.values())
    if total1 + total2 == 0:
        return 0.0
    common = 0
    for k, c in fp1.items():
        if k in fp2:
            common += min(c, fp2[k])
    return 2.0 * common / (total1 + total2)


def morgan_dice(mol1: Mol, mol2: Mol, radius: int = 3) -> float:
    return dice_similarity(morgan_fingerprint(mol1, radius),
                           morgan_fingerprint(mol2, radius))
