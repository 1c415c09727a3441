"""Host assembly and scoring of the torch port against abcnet_tpu (CPU).

Same peak dicts in, the same SMILES out (exact string equality), for the
numpy assembler and for the native one (which the port builds at first
use into its own build directory).
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
    p = tmp_path / "r.csv"
    p.write_text(",InChI,smiles_pred\n0,InChI=1S/CH4/h1H4,C\n")
    with pytest.raises(SystemExit, match="later slice"):
        scoring.read_results_csv(str(p))
