"""eval/decode_ceiling.py against the JAX package's scripts/decode_ceiling.py,
on the CPU.

  * `classify` equals the script's on crafted (truth, prediction) pairs,
    one per bucket and a prediction of None;
  * the whole run for 6 samples a mode from seed 1000, with production
    and with oracle targets, and with oracle targets from seed 1020 (a
    window with struct failures in indigo mode): the printout equals the
    script's main() byte for byte (tables and failure lists), and every
    sample's prediction equals the script's decode of the same logits
    (exact: both are host-side on equal peak dicts);
  * the entry point refuses to run without a GPU unless asked for the
    CPU.

The script is loaded by path; nothing in scripts/ changes.
"""

import contextlib
import importlib.util
import io
import os
import random
import sys

import numpy as np
import pytest

from abcnet_tpu_torch.eval import decode_ceiling as dc
from torch_parity import REPO


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_decode_ceiling", os.path.join(REPO, "scripts",
                                           "decode_ceiling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PAIRS = [
    ("CCO", "OCC"),                          # ok
    ("CCO", "CCN"),                          # struct
    ("CC(O)F", "C[C@H](O)F"),                # stereo+
    ("C[C@H](O)F", "CC(O)F"),                # stereo-
    ("C[C@H](O)F", "C[C@@H](O)F"),           # stereo~ (tetrahedral)
    ("C/C=C/C", "C/C=C\\C"),                 # stereo~ (E/Z)
    ("C/C=C/C", "CC=CC"),                    # stereo-
    ("CCO", None),                           # decode0
    ("CCO", "C1CC"),                         # parse:<Exception>
    ("C(", "CCO"),                           # parse on the truth's side
]


def test_classify_matches_jax(jax_script):
    got = [dc.classify(t, p) for t, p in PAIRS]
    assert got == [jax_script.classify(t, p) for t, p in PAIRS]
    assert {b.split(":")[0] for b in got} == {
        "ok", "struct", "stereo+", "stereo-", "stereo~", "decode0", "parse"}


def _jax_main(jax_script, argv):
    old = sys.argv
    sys.argv = ["decode_ceiling.py", *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jax_script.main()
    finally:
        sys.argv = old
    return buf.getvalue()


def _jax_pred(jax_script, sample, oracle):
    if oracle:
        preds = jax_script.fake_logits_from_targets(
            jax_script.encode_targets_np(
                jax_script.parse_atoms_string(sample.atoms_string),
                jax_script.parse_bonds_string(sample.bonds_string)))
    else:
        preds = jax_script.perfect_logits_production(sample)
    return jax_script.assemble_batch(jax_script.extract_peaks(preds))[0]


@pytest.mark.parametrize("seed0,oracle", [(1000, False), (1000, True),
                                          (1020, True)],
                         ids=["production", "oracle", "oracle_fails"])
def test_run_matches_the_jax_script(jax_script, seed0, oracle):
    argv = ["6", str(seed0)] + (["oracle"] if oracle else [])
    want = _jax_main(jax_script, argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = dc.main(argv + ["--device", "cpu"])
    assert buf.getvalue() == want
    for mode, r in res.items():
        assert r.made == 6 and len(r.outcomes) == 6
        for seed, bucket, pred in r.outcomes:
            sample = jax_script.generate_sample(random.Random(seed),
                                                mode=mode)
            assert pred == _jax_pred(jax_script, sample, oracle), seed
            assert bucket == jax_script.classify(sample.smiles, pred)
    if seed0 == 1020:
        assert res["indigo"].fails           # the window holds failures


def test_perfect_logits_are_the_jax_packages(jax_script):
    sample = jax_script.generate_sample(random.Random(1001), mode="indigo")
    for oracle in (False, True):
        got = dc.perfect_logits(sample, oracle)
        want = jax_script.perfect_logits_production(sample) if not oracle \
            else jax_script.fake_logits_from_targets(
                jax_script.encode_targets_np(
                    jax_script.parse_atoms_string(sample.atoms_string),
                    jax_script.parse_bonds_string(sample.bonds_string)))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)


def test_main_refuses_without_a_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dc.main(["1"])
