"""Host assembly and scoring of the torch port against abcnet_tpu (CPU).

Same peak dicts in, the same SMILES out (exact string equality), for the
numpy assembler and for the native one (which the port builds at first
use into its own build directory), in the one native call a batch that
the serving loop makes and in a process pool's ranges of rows.
"""

import random

import numpy as np
import pytest

from abcnet_tpu.data.encode import (encode_targets_np, parse_atoms_string,
                                    parse_bonds_string)
from abcnet_tpu.data.generate import generate_sample
from abcnet_tpu.eval import scoring as jax_scoring
from abcnet_tpu.infer import assemble as jax_assemble
from abcnet_tpu.infer import extract_peaks
from abcnet_tpu.utils.diagnostics import fake_logits_from_targets
from abcnet_tpu_torch.eval import scoring
from abcnet_tpu_torch.infer import assemble
from abcnet_tpu_torch.infer import native
from abcnet_tpu_torch.infer.decode import (pack_peaks, peaks_spec,
                                           unpack_peaks_host)
from abcnet_tpu_torch.infer.native import load_native
from torch_parity import FIXTURE


def _corpus_peaks(n=8, seed0=4000):
    """Peak dicts (batch of one) decoded from the perfect logits of
    generated molecules, plus one with the atom peaks jittered so that
    matching, re-matching and valence repair all get exercised."""
    out = []
    for seed in range(seed0, seed0 + 3 * n):
        sample = generate_sample(random.Random(seed), mode="mixed")
        if sample is None:
            continue
        t = encode_targets_np(parse_atoms_string(sample.atoms_string),
                              parse_bonds_string(sample.bonds_string))
        peaks = {k: np.asarray(v) for k, v in
                 extract_peaks(fake_logits_from_targets(t)).items()}
        out.append(peaks)
        if len(out) == n:
            break
    jit = {k: v.copy() for k, v in out[0].items()}
    rng = np.random.default_rng(0)
    jit["atom_xy"] = jit["atom_xy"] + rng.integers(-1, 2, jit["atom_xy"].shape,
                                                   dtype=np.int32)
    jit["bond_score"] = rng.uniform(0.5, 1.0, jit["bond_score"].shape
                                    ).astype(np.float32)
    return out + [jit]


def _batch(peak_list):
    return {k: np.concatenate([p[k] for p in peak_list]) for k in peak_list[0]}


@pytest.fixture(scope="module")
def peaks():
    return _batch(_corpus_peaks())


def test_numpy_assembler_matches_jax(peaks):
    want = jax_assemble.assemble_batch(peaks, native=False)
    got = assemble.assemble_batch(peaks, native=False)
    assert got == want
    assert sum(s is not None for s in got) >= 6


def test_native_assembler_matches_jax(peaks):
    assert load_native() is not None, "g++ build of native/*.cpp failed"
    want = jax_assemble.assemble_batch(peaks, native=False)
    assert assemble.assemble_batch(peaks, native=True) == want
    assert jax_assemble.assemble_batch(peaks, native=True) == want


@pytest.fixture(scope="module")
def rows(peaks):
    """The corpus batch with two rows that have no SMILES among its rows:
    one with no valid atom, one with no valid bond."""
    no_atom = {k: v[:1].copy() for k, v in peaks.items()}
    no_atom["atom_valid"][:] = False
    no_bond = {k: v[1:2].copy() for k, v in peaks.items()}
    no_bond["bond_valid"][:] = False
    head = {k: v[:4] for k, v in peaks.items()}
    tail = {k: v[4:] for k, v in peaks.items()}
    return _batch([head, no_atom, tail, no_bond])


def _as_fetched(peaks):
    """`peaks` in the layout the serving pipeline's fetch hands over:
    views with row strides into two packed buffers, bools copied."""
    import torch
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in peaks.items()}
    return unpack_peaks_host(*pack_peaks(tensors), peaks_spec(tensors))


# (overshoot_cap, rematch_max, vprune_score_max)
SETTINGS = {
    "constants": (assemble.OVERSHOOT_CAP, assemble.REMATCH_MAX,
                  assemble.VPRUNE_SCORE_MAX),
    "no_overshoot_cap": (0.0, assemble.REMATCH_MAX,
                         assemble.VPRUNE_SCORE_MAX),
    "no_rematch": (assemble.OVERSHOOT_CAP, 0.0, assemble.VPRUNE_SCORE_MAX),
    "no_vprune": (assemble.OVERSHOOT_CAP, assemble.REMATCH_MAX, 0.0),
    "reference": (0.0, 0.0, 0.0),
}


@pytest.mark.parametrize("subcell", [True, False])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_batched_native_call_matches_every_assembler(rows, setting, subcell,
                                                     monkeypatch):
    """One native call for the whole batch gives, byte for byte, the
    numpy assembler's strings and the JAX package's, per row through its
    two ctypes calls and in numpy, from contiguous rows and from the
    fetched layout, with a buffer large enough at once and with one far
    too short (the retry)."""
    assert load_native() is not None, "g++ build of the port's library"
    cap, rematch, vprune = SETTINGS[setting]
    kw = dict(overshoot_cap=cap, subcell=subcell, rematch_max=rematch,
              vprune_score_max=vprune)
    n = rows["atom_valid"].shape[0]
    got, graph_ns, smiles_ns = native.assemble_smiles_batch_native(
        rows, cap, subcell, rematch, vprune)
    assert graph_ns > 0 and smiles_ns > 0
    assert got == [assemble.assemble_smiles(rows, i, **kw)
                   for i in range(n)]
    assert got == [jax_assemble.assemble_smiles_native(rows, i, **kw)
                   for i in range(n)]
    assert got == [jax_assemble.assemble_smiles(rows, i, **kw)
                   for i in range(n)]
    assert got[4] is None and got[-1] is None
    assert sum(s is not None for s in got) >= 6
    fetched = _as_fetched(rows)
    assert not fetched["atom_xy"].flags.c_contiguous
    for tiny in (0, 1):
        monkeypatch.setattr(native, "_SMILES_BYTES_A_ROW", tiny)
        assert native.assemble_smiles_batch_native(
            fetched, cap, subcell, rematch, vprune)[0] == got
    monkeypatch.undo()
    if cap == assemble.OVERSHOOT_CAP:
        # the serial native path of assemble_batch is this call
        del kw["overshoot_cap"]
        assert assemble.assemble_batch(fetched, **kw) == got
        assert jax_assemble.assemble_batch(rows, native=True, **kw) == got
        assert jax_assemble.assemble_batch(rows, native=False, **kw) == got


def test_batched_native_call_refuses_a_misshapen_array(rows):
    bad = dict(rows, bond_type=rows["bond_type"][:, :-1])
    with pytest.raises(ValueError, match="bond_type"):
        native.assemble_smiles_batch_native(bad, 2.0, True, 3.0, 0.85)
    empty = {k: v[:0] for k, v in rows.items()}
    assert native.assemble_smiles_batch_native(
        empty, 2.0, True, 3.0, 0.85) == ([], 0, 0)


def test_reference_constants_carried():
    assert assemble.OVERSHOOT_CAP == jax_assemble.OVERSHOOT_CAP == 2.0
    assert assemble.REMATCH_MAX == jax_assemble.REMATCH_MAX == 3.0
    assert assemble.VPRUNE_SCORE_MAX == jax_assemble.VPRUNE_SCORE_MAX == 0.85


def test_assembly_pool_matches_serial(peaks):
    pool = assemble.make_assembly_pool(2)
    try:
        got = assemble.assemble_batch(peaks, pool=pool)
    finally:
        pool.close()
        pool.join()
    assert got == assemble.assemble_batch(peaks)


def test_score_pairs_matches_jax():
    z = np.load(FIXTURE)
    truth = z["truth"].tolist()
    preds = [p or None for p in z["tpu_bf16"].tolist()]
    preds[3] = None
    preds[5] = "not a smiles"
    assert scoring.score_pairs(truth, preds).__dict__ == \
        jax_scoring.score_pairs(truth, preds).__dict__


def test_results_csv_matches_pandas_writer(tmp_path):
    truth = ["CCO", "c1ccccc1", "C(=O)O"]
    preds = ["CCO", None, "CC"]
    ours, theirs = tmp_path / "a.csv", tmp_path / "b.csv"
    scoring.write_results_csv(str(ours), truth, preds)
    jax_scoring.write_results_csv(str(theirs), truth, preds)
    assert ours.read_text() == theirs.read_text()
    assert scoring.read_results_csv(str(theirs)) == (truth, preds)


def test_cal_acc_rejects_inchi_truths(tmp_path):
    """InChI truths were refused until chem/inchi.py came to the port;
    now they are converted as the JAX package's cal-acc converts them,
    and only a CSV with neither truth column is refused."""
    from abcnet_tpu.chem.inchi import inchi_to_smiles as jax_inchi_to_smiles

    p = tmp_path / "r.csv"
    p.write_text(",InChI,smiles_pred\n0,InChI=1S/CH4/h1H4,C\n1,,CC\n")
    assert scoring.read_results_csv(str(p)) == (
        [jax_inchi_to_smiles("InChI=1S/CH4/h1H4"), None], ["C", "CC"])
    p.write_text(",truth,smiles_pred\n0,C,C\n")
    with pytest.raises(SystemExit, match="'smiles' or 'InChI'"):
        scoring.read_results_csv(str(p))
