"""Host-side graph assembly: compact peak arrays -> canonical SMILES.

Parity surface: the tail of the reference decode loop
(the reference's src/img2smiles2.py:171-317) and its MolBlock writer
(src/generate_smiles.py:10-119):

  * atom peak dedup at squared distance < 4, first-in-scan-order wins
    (img2smiles2.py:181-186)
  * bond endpoint -> atom matching with the anisotropic leaky-relu score
    (img2smiles2.py:20-22, 193-210): overshoot along the bond axis is
    half-penalized, perpendicular error double-penalized
  * self-loop and duplicate-pair removal (img2smiles2.py:217-231)
  * valence sanity fixups rewriting the element by observed valence
    (img2smiles2.py:247-271), unbonded-atom removal + 1-based reindex
    (img2smiles2.py:236-245, 273-297)
  * aromatic-heteroatom implicit-H collection (img2smiles2.py:299-311)
  * V2000 MolBlock with MRV_IMPLICIT_H Sgroups -> canonical SMILES —
    via the framework's own chem stack instead of RDKit.

The reference fans this loop out over a Pool(32) of CPU workers
(src/multi_proc_img2smiles2.py:268-300); `assemble_batch` keeps that
option but the per-image cost here is tiny because the device already
reduced maps to peaks.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..chem.molblock import parse_molblock, write_molblock
from ..chem.smiles import to_smiles
from ..data import vocab

# Reference valence table (img2smiles2.py:32-34).
ATOM_MAX_VALENCE = {
    "<unknown>": 4, "O": 2, "C": 4, "N": 3, "F": 1, "H": 1, "S": 6,
    "Cl": 1, "P": 5, "Br": 1, "B": 3, "I": 1, "Si": 4, "Se": 6,
    "Te": 6, "As": 3, "Al": 3, "Zn": 2, "Ca": 2, "Ag": 1,
}

# Observed-valence -> element rewrite (img2smiles2.py:258-271).
_VALENCE_REWRITE = {2: "O", 3: "N", 4: "C", 5: "P", 6: "S", 7: "Cl"}


def _leaky_relu(x: np.ndarray) -> np.ndarray:
    return np.maximum(x, 0.5 * x)


# Along-axis overshoot tolerance cap (grid units). The reference score
# (img2smiles2.py:20-22) halves the along-axis penalty without limit, so
# in crowded drawings a far atom sitting almost exactly ON the bond axis
# can beat the true atom sitting ~1 unit off-axis (observed: a CF3
# fluorine 3.9 units beyond the endpoint outscoring the true pyridine N
# by 0.02 — the reference matcher loses the same molecule). Overshoot
# exists to absorb the label-to-atom-center rendering gap, which is
# bounded (~<2 grid units); beyond the cap the slope rises to 2.0
# (0.5 + _OVERSHOOT_EXTRA_SLOPE, continuous). Cap <= 0 restores exact
# reference behavior.
OVERSHOOT_CAP = 2.0
_OVERSHOOT_EXTRA_SLOPE = 1.5

# Self-loop bond re-matching (r5, atom-drop bucket of
# logs/failure_taxonomy_r4.log): when both endpoints of a bond argmin
# to the SAME atom, the reference drops the bond outright
# (img2smiles2.py:217-219) — and with it any degree-1 atom whose only
# bond this was. Instead, re-match to the best DISTINCT atom pair
# (keep one winner, move the other endpoint to its runner-up, cheaper
# total first), accepting only while the moved endpoint still scores
# <= REMATCH_MAX grid units. Activates ONLY on would-be-dropped bonds;
# every other match is bit-identical to the reference rule. <= 0
# restores exact reference behavior.
REMATCH_MAX = 3.0

# Valence-aware FP-bond prune (r5, overdeg bucket of
# logs/atom_drop_probe_r5.log: endpoint theft measured ZERO; the
# over-valence states that trigger the reference's element rewrite —
# its elem-swap failure bucket, img2smiles2.py:247-271 — are caused by
# false-positive detected bonds). BEFORE rewriting an atom's element to
# fit an impossible valence, drop its lowest-confidence incident bond
# when (a) the bond's heatmap score is below this gate (probe: TP bonds
# p5 ~0.78-0.85, median ~0.93; FP median 0.72-0.83), (b) dropping
# resolves the violation, and (c) both endpoints keep degree >= 1.
# Activates ONLY where the reference would rewrite an element.
# ADOPTED at 0.85 by the n=256/lineage chip A/B on the step-37500
# production weights (logs/vprune_r5d.log): combined exact
# 0.8164 -> 0.8262, rdkit 0.8594 -> 0.8672, indigo 0.7734 -> 0.7852,
# dice up at every gate, decode_rate 1.0 — an exact win with no
# per-lineage regression, matching the preliminary CPU A/B
# (logs/vprune_cpu96.log). 0.90 tied on exact; 0.85 keeps the larger
# margin below the true-bond score median (~0.93). Pass 0.0 for exact
# reference behavior (img2smiles2.py:247-271 element rewrite).
VPRUNE_SCORE_MAX = 0.85


def _overshoot_extra(along: np.ndarray, cap: float) -> np.ndarray:
    """Extra penalty for along-axis overshoot beyond `cap` (along is the
    signed axis residual; negative = atom beyond the endpoint)."""
    if cap is None or cap <= 0:
        return np.zeros_like(along)
    return np.maximum(-along - cap, 0.0) * _OVERSHOOT_EXTRA_SLOPE


def _graph_to_smiles(types: List[str], charges: List[int],
                     positions: List[Sequence[float]], hs: List[int],
                     bond_pairs_1b: List[List[int]],
                     bond_orders: List[int],
                     perceive_stereo: bool = True,
                     salvage_aromatic: bool = True) -> Optional[str]:
    """Shared tail: implicit-H collection + MolBlock -> canonical SMILES
    (img2smiles2.py:299-317, generate_smiles.py:10-119).

    perceive_stereo assigns tetrahedral parities from the decoded
    wedge/hash bonds + 2-D coordinates and prunes non-stereogenic tags
    (the RDKit MolFromMolBlock + AssignStereochemistry behavior), so
    the emitted SMILES are isomeric like the reference's
    MolToSmiles(isomericSmiles=True) — matching the generator's
    isomeric ground truth.

    salvage_aromatic: when the predicted type-4 bonds form a subgraph
    with no valid alternating assignment (the decode-to-None class —
    kekulization fails, exactly where the reference's MolFromMolBlock
    returns None), retry once with aromatic bonds demoted to single: a
    best-effort molecule scores partial fingerprint credit where None
    scores zero on every metric. Documented improvement over reference
    behavior; pass False for exact parity.
    """
    out = _graph_to_smiles_once(types, charges, positions, hs,
                                bond_pairs_1b, bond_orders,
                                perceive_stereo)
    if out is None and salvage_aromatic and any(
            o == 4 for o in bond_orders):
        out = _graph_to_smiles_once(
            types, charges, positions, hs, bond_pairs_1b,
            [1 if o == 4 else o for o in bond_orders], perceive_stereo)
    return out


def _graph_to_smiles_once(types, charges, positions, hs, bond_pairs_1b,
                          bond_orders, perceive_stereo) -> Optional[str]:
    impl_h: List[int] = []
    for (x, y), order_ in zip(bond_pairs_1b, bond_orders):
        if order_ == 4:
            for a1b in (x, y):
                if types[a1b - 1] != "C" and hs[a1b - 1] != 0 \
                        and a1b not in impl_h:
                    impl_h.append(a1b)
    block = write_molblock(types, bond_pairs_1b, charges, bond_orders,
                           positions, impl_h)
    try:
        mol = parse_molblock(block)
        # RDKit's MolFromMolBlock removes explicit hydrogens by default
        # (generate_smiles.py:115); AddHs-rendered molecules would
        # otherwise emit [H]-laden SMILES that never exact-match.
        mol = mol.remove_explicit_h_atoms()
        if perceive_stereo:
            # Same perception pair the generator applies to its pixel
            # coordinates (data/generate.py GT block) — wedges for
            # tetrahedral parity, drawn geometry for cis/trans. The
            # cis/trans sign test compares two cross products, so it is
            # invariant under the MolBlock coordinate transform.
            from ..chem.ez import assign_ez_from_coords
            from ..chem.stereo import (assign_parities_from_wedges,
                                       prune_nonstereogenic)
            assign_parities_from_wedges(mol)
            assign_ez_from_coords(mol)
            prune_nonstereogenic(mol)
        return to_smiles(mol, canonical=True)
    except Exception:
        return None


def assemble_smiles_native(peaks: Dict[str, np.ndarray], index: int,
                           overshoot_cap: float = OVERSHOOT_CAP,
                           subcell: bool = True,
                           rematch_max: float = REMATCH_MAX,
                           vprune_score_max: float = VPRUNE_SCORE_MAX
                           ) -> Optional[str]:
    """C++ fast path: graph assembly AND the canonical-SMILES tail in
    native code (native/assemble.cpp + native/smiles.cpp — the decode
    profile puts to_smiles at ~68% of host assembly). Falls back to the
    numpy/chem-stack path when the shared library is not built;
    test_native_smiles.py asserts exact string agreement between the
    two."""
    from .native import (assemble_graph_native, graph_to_smiles_native,
                         load_native)
    if load_native() is None:
        return assemble_smiles(peaks, index, overshoot_cap=overshoot_cap,
                               subcell=subcell, rematch_max=rematch_max,
                               vprune_score_max=vprune_score_max)
    out = assemble_graph_native(peaks, index, overshoot_cap, subcell,
                                rematch_max, vprune_score_max)
    if out is None:
        return None
    pos, a_type, a_charge, a_hs, bonds, b_orders = out
    return graph_to_smiles_native(pos, a_type, a_charge, a_hs,
                                  bonds, b_orders)


def assemble_smiles(peaks: Dict[str, np.ndarray], index: int,
                    verbose: bool = False,
                    midpoint_check: Optional[float] = None,
                    overshoot_cap: float = OVERSHOOT_CAP,
                    subcell: bool = True,
                    rematch_max: float = REMATCH_MAX,
                    vprune_score_max: float = VPRUNE_SCORE_MAX
                    ) -> Optional[str]:
    """Decode one image's peaks (row `index` of the batch arrays).

    midpoint_check: optional grid-unit threshold reproducing the
    multiprocessing decoder's extra sanity rule — drop a bond when the
    midpoint of its matched atoms is farther than this from the bond
    peak (multi_proc_img2smiles2.py:160-162 uses 7 px = 1.75 units).
    overshoot_cap: along-axis overshoot tolerance cap (see
    OVERSHOOT_CAP above); pass 0 for exact reference matching.
    subcell: when the peaks carry atom_sub/bond_sub parabolic offsets
    (infer/decode.py:subcell_offsets), dedup distances, endpoint
    matching and midpoint checks run on the refined coordinates;
    MolBlock/stereo coordinates stay integer cells (the encoder's
    quantization — generate.py:237-246). False (or peaks without the
    arrays) = exact reference integer-cell matching.
    """
    av = peaks["atom_valid"][index]
    bv = peaks["bond_valid"][index]
    if not av.any() or not bv.any():
        return None
    use_sub = subcell and "atom_sub" in peaks

    # -- atoms: reference iterates nonzero() in row-major scan order and
    # dedups at d^2 < 4 keeping the first (img2smiles2.py:177-191).
    axy = peaks["atom_xy"][index][av]
    a_type = peaks["atom_type"][index][av]
    a_charge = peaks["atom_charge"][index][av]
    a_hs = peaks["atom_hs"][index][av]
    amxy = axy.astype(np.float64)
    if use_sub:
        amxy = amxy + np.asarray(peaks["atom_sub"][index][av], np.float64)
    order = np.lexsort((axy[:, 1], axy[:, 0]))

    apos: List[np.ndarray] = []        # integer cells (MolBlock coords)
    mpos: List[np.ndarray] = []        # match coords (refined)
    types: List[str] = []
    charges: List[int] = []
    hs: List[int] = []
    for i in order:
        m = amxy[i]
        if mpos and min(((np.asarray(mpos) - m) ** 2).sum(-1)) < 4:
            continue
        apos.append(axy[i].astype(np.float64))
        mpos.append(m)
        types.append(vocab.ATOM_DEVOCAB[int(a_type[i])])
        charges.append(vocab.CHARGE_DEVOCAB[int(a_charge[i])])
        hs.append(int(a_hs[i]))
    atoms_position = np.asarray(mpos)                    # (A, 2) match
    atoms_cell = np.asarray(apos)                        # (A, 2) int

    # -- bonds --
    bxy = peaks["bond_xy"][index][bv].astype(np.float64)  # (Bn, 2)
    if use_sub:
        bxy = bxy + np.asarray(peaks["bond_sub"][index][bv], np.float64)
    bdelta = peaks["bond_delta"][index][bv].astype(np.float64)
    btype = peaks["bond_type"][index][bv]
    bscores = (np.asarray(peaks["bond_score"][index][bv], np.float64)
               if "bond_score" in peaks else None)
    if len(bxy) == 0:
        return None

    # Endpoint matching (img2smiles2.py:193-210).
    p1 = (bxy + bdelta)[:, None, :]                       # (Bn, 1, 2)
    p2 = (bxy - bdelta)[:, None, :]
    ap = atoms_position[None, :, :]                       # (1, A, 2)
    norm = np.sqrt((bdelta ** 2).sum(-1, keepdims=True))
    norm = np.maximum(norm, 1e-9)
    e1 = bdelta / norm
    e2 = np.stack([-e1[:, 1], e1[:, 0]], axis=-1)
    e1 = e1[:, None, :]
    e2 = e2[:, None, :]
    al1 = ((p1 - ap) * e1).sum(-1)
    al2 = -((p2 - ap) * e1).sum(-1)
    d1 = (np.abs(_leaky_relu(al1)) + _overshoot_extra(al1, overshoot_cap)
          + np.abs(2 * ((p1 - ap) * e2).sum(-1)))
    d2 = (np.abs(_leaky_relu(al2)) + _overshoot_extra(al2, overshoot_cap)
          + np.abs(2 * ((p2 - ap) * e2).sum(-1)))
    atom_index1 = d2.argmin(-1)                           # begin atoms
    atom_index2 = d1.argmin(-1)                           # end atoms

    # Self-loop / duplicate-pair removal (img2smiles2.py:217-231),
    # with self-loop re-matching (see REMATCH_MAX above).
    n_atoms = atoms_position.shape[0]
    bond_pairs: List[List[int]] = []
    bond_orders: List[int] = []
    bond_scores: List[float] = []
    for i in range(len(bxy)):
        i1, i2 = int(atom_index1[i]), int(atom_index2[i])
        if i1 == i2:
            if rematch_max is None or rematch_max <= 0 or n_atoms < 2:
                continue
            d1r, d2r = d1[i].copy(), d2[i].copy()
            d1r[i2] = np.inf                 # runner-up end (!= winner)
            d2r[i1] = np.inf                 # runner-up begin
            r2, r1 = int(d1r.argmin()), int(d2r.argmin())
            ok_a = d1r[r2] <= rematch_max    # begin=i1, end=r2
            ok_b = d2r[r1] <= rematch_max    # begin=r1, end=i2
            if not ok_a and not ok_b:
                continue
            cost_a = d2[i, i1] + d1r[r2] if ok_a else np.inf
            cost_b = d2r[r1] + d1[i, i2] if ok_b else np.inf
            if cost_a <= cost_b:
                i2 = r2
            else:
                i1 = r1
        if [i1, i2] in bond_pairs or [i2, i1] in bond_pairs:
            continue
        if midpoint_check is not None:
            mid = (atoms_position[i1] + atoms_position[i2]) / 2.0
            if np.hypot(*(mid - bxy[i])) > midpoint_check:
                continue
        bond_pairs.append([i1, i2])
        bond_orders.append(vocab.BOND_DEVOCAB[int(btype[i])])
        bond_scores.append(float(bscores[i]) if bscores is not None
                           else 1.0)
    if not bond_pairs:
        return None

    # Valence fixups (img2smiles2.py:247-271).
    counts = [-c for c in charges]
    for (x, y), order_ in zip(bond_pairs, bond_orders):
        n = 1 if order_ >= 4 else order_
        counts[x] += n
        counts[y] += n

    # Valence-aware FP-bond prune (see VPRUNE_SCORE_MAX above): runs
    # strictly before — and only where — the reference element rewrite
    # would fire.
    if vprune_score_max and vprune_score_max > 0:
        deg = [0] * len(types)
        for x, y in bond_pairs:
            deg[x] += 1
            deg[y] += 1
        drops: set = set()
        for serial in range(len(types)):
            while ATOM_MAX_VALENCE.get(types[serial], 4) < counts[serial]:
                cands = [(bond_scores[k], k)
                         for k, (x, y) in enumerate(bond_pairs)
                         if k not in drops and serial in (x, y)
                         and bond_scores[k] < vprune_score_max
                         and deg[x] > 1 and deg[y] > 1]
                if not cands:
                    break
                _, k = min(cands)
                drops.add(k)
                x, y = bond_pairs[k]
                n = 1 if bond_orders[k] >= 4 else bond_orders[k]
                counts[x] -= n
                counts[y] -= n
                deg[x] -= 1
                deg[y] -= 1
                if verbose:
                    print(f"vprune bond {x}-{y} "
                          f"score {bond_scores[k]:.3f}")
        if drops:
            bond_pairs = [p for k, p in enumerate(bond_pairs)
                          if k not in drops]
            bond_orders = [o for k, o in enumerate(bond_orders)
                           if k not in drops]
            if not bond_pairs:
                return None

    for serial, count in enumerate(counts):
        if ATOM_MAX_VALENCE.get(types[serial], 4) < count:
            if verbose:
                print(f"valence fix atom {serial} {types[serial]} -> "
                      f"{_VALENCE_REWRITE.get(count)}")
            if count in _VALENCE_REWRITE:
                types[serial] = _VALENCE_REWRITE[count]

    # Drop unbonded atoms + 1-based reindex (img2smiles2.py:236-245,273-297).
    used = set()
    for x, y in bond_pairs:
        used.add(x)
        used.add(y)
    corresponding = []
    final_types: List[str] = []
    final_charges: List[int] = []
    final_pos: List[Sequence[float]] = []
    final_hs: List[int] = []
    k = 1
    for i in range(len(types)):
        corresponding.append(k)
        if i in used:
            final_types.append(types[i])
            final_charges.append(charges[i])
            final_pos.append(list(atoms_cell[i]))
            final_hs.append(hs[i])
            k += 1
    bond_pairs_1b = [[corresponding[x], corresponding[y]]
                     for x, y in bond_pairs]
    return _graph_to_smiles(final_types, final_charges, final_pos,
                            final_hs, bond_pairs_1b, bond_orders)


def _assemble_range(host: Dict[str, np.ndarray], lo: int, hi: int,
                    native: bool, subcell: bool,
                    rematch_max: float = REMATCH_MAX,
                    vprune_score_max: float = VPRUNE_SCORE_MAX
                    ) -> List[Optional[str]]:
    """Worker task: assemble images [lo, hi) of a peak batch. A range
    per worker (instead of one task per image) pickles the batch dict
    once per worker instead of once per image."""
    fn = assemble_smiles_native if native else assemble_smiles
    return [fn(host, i, subcell=subcell, rematch_max=rematch_max,
               vprune_score_max=vprune_score_max)
            for i in range(lo, hi)]


def make_assembly_pool(processes: int):
    """Persistent worker pool for the serving loop (the reference holds
    one Pool(32) for its whole run, multi_proc_img2smiles2.py:268) —
    a per-call spawn pool pays interpreter+import startup every batch.
    Caller owns the pool (close() when done); pass it to
    assemble_batch(pool=...)."""
    import multiprocessing as mp
    pool = mp.get_context("spawn").Pool(processes)
    # Public worker count: assemble_batch sizes its chunks from this
    # instead of the private Pool._processes attribute.
    pool.n_workers = processes
    return pool


def assemble_batch(peaks: Dict[str, np.ndarray], processes: int = 0,
                   native: bool = True,
                   subcell: bool = True,
                   pool=None,
                   rematch_max: float = REMATCH_MAX,
                   vprune_score_max: float = VPRUNE_SCORE_MAX
                   ) -> List[Optional[str]]:
    """Decode every image in a batch of peak arrays (host numpy).

    native=True uses the C++ assembler when built (falls back
    transparently). processes > 1 fans images out over a process pool —
    the multi_proc_img2smiles2.py Pool(32) role; with the on-device peak
    reduction the serial path is usually fast enough. pool: a persistent
    pool from make_assembly_pool (preferred in serving loops; overrides
    `processes`). subcell=False ignores any atom_sub/bond_sub refinement
    arrays (reference integer-cell matching).
    """
    host = {k: np.asarray(v) for k, v in peaks.items()}
    n = host["atom_valid"].shape[0]
    if pool is None and processes and processes > 1 and n > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(processes) as tmp:
            return assemble_batch(host, native=native, subcell=subcell,
                                  pool=tmp, rematch_max=rematch_max,
                                  vprune_score_max=vprune_score_max)
    if pool is not None and n > 1:
        workers = getattr(pool, "n_workers", None) or getattr(
            pool, "_processes", None) or 2
        step = -(-n // workers)
        ranges = [(host, lo, min(lo + step, n), native, subcell,
                   rematch_max, vprune_score_max)
                  for lo in range(0, n, step)]
        out: List[Optional[str]] = []
        for part in pool.starmap(_assemble_range, ranges):
            out.extend(part)
        return out
    fn = assemble_smiles_native if native else assemble_smiles
    return [fn(host, i, subcell=subcell, rematch_max=rematch_max,
               vprune_score_max=vprune_score_max)
            for i in range(n)]
