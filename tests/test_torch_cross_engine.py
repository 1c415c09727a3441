"""eval/cross_engine_eval.py against the JAX package's
scripts/cross_engine_eval.py, on the CPU.

  * gen_paired_pools(881001, 6): both engines' pools equal the script's,
    SMILES, label strings and drawings (one Pillow here for both sides);
  * the skip rule on seeds whose first attempt it drops: engine A
    rejects the molecule (seed 320), engine B rejects it (389), the two
    label SMILES differ (1235); the pools equal the script's, and the
    dropped attempt is what the JAX package's generator makes of it;
  * the printout of main() equal to the script's main() line for line
    (the seconds aside) when both serve the same predictions (weights,
    serving pipeline and assembler replaced on both sides by the same
    stand-ins);
  * the entry point refuses to run without a GPU unless asked for the CPU.

The script is loaded by path; nothing in scripts/ changes.
"""

import contextlib
import importlib.util
import io
import os
import random
import re
import sys
import types

import numpy as np
import pytest
import torch

from abcnet_tpu_torch.eval import cross_engine_eval as ce
from torch_parity import REPO


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_cross_engine_eval", os.path.join(REPO, "scripts",
                                              "cross_engine_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_pools_equal(got, want):
    assert sorted(got) == sorted(want) == ["a", "b"]
    for eng in want:
        assert len(got[eng]) == len(want[eng])
        for g, w in zip(got[eng], want[eng]):
            assert (g.smiles, g.atoms_string, g.bonds_string) == \
                (w.smiles, w.atoms_string, w.bonds_string)
            np.testing.assert_array_equal(g.image, w.image)
    assert [s.smiles for s in got["a"]] == [s.smiles for s in got["b"]]


def test_constants_match_the_script(jax_script):
    assert (ce.EVAL_BATCH, ce.MAX_ATOMS) == (jax_script.EVAL_BATCH,
                                             jax_script.MAX_ATOMS)
    assert f"gen_paired_pools({ce.POOL_SEED}, n)" in open(
        jax_script.__file__).read()


def test_paired_pools_match_jax(jax_script):
    got = ce.gen_paired_pools(ce.POOL_SEED, 6)
    _assert_pools_equal(got, jax_script.gen_paired_pools(ce.POOL_SEED, 6))


@pytest.mark.parametrize("seed,why", [(320, "a"), (389, "b"),
                                      (1235, None)],
                         ids=["engine_a_rejects", "engine_b_rejects",
                              "smiles_differ"])
def test_skip_rule_matches_jax(jax_script, seed, why):
    from abcnet_tpu.chem import to_smiles
    from abcnet_tpu.chem.random_mol import random_molecule
    from abcnet_tpu.data.generate import generate_sample

    got = ce.gen_paired_pools(seed, 1)
    _assert_pools_equal(got, jax_script.gen_paired_pools(seed, 1))
    # The first two attempts, drawn by the JAX package: the first is
    # dropped (the engine named rejects it, or both draw it and their
    # SMILES differ), the second is the pools' molecule.
    mol_rng = random.Random(seed)
    drawn = []
    for _ in range(2):
        smi = to_smiles(random_molecule(mol_rng, max_atoms=ce.MAX_ATOMS),
                        canonical=True)
        mseed = mol_rng.getrandbits(32)
        drawn.append({e: generate_sample(random.Random(f"{mseed}-{e}"),
                                         mode="rdkit", smiles=smi, engine=e)
                      for e in ("a", "b")})
    first, second = drawn
    if why is None:
        assert None not in first.values()
        assert first["a"].smiles != first["b"].smiles
    else:
        assert first[why] is None
        assert why == "a" or first["a"] is not None
    for e in ("a", "b"):
        assert got[e][0].smiles == second[e].smiles
        np.testing.assert_array_equal(got[e][0].image, second[e].image)


def _stand_ins():
    """A serving pipeline that hands its images on, and an assembler that
    answers a row with a fixed molecule or nothing, by call and row."""
    calls = [0]

    def make_pipeline(*args, **kwargs):
        return lambda imgs: {"images": np.asarray(imgs)}

    def assemble(peaks):
        c = calls[0]
        calls[0] += 1
        return [None if (r + c) % 3 == 0 else "CCO"
                for r in range(len(peaks["images"]))]
    return make_pipeline, assemble


def _strip_seconds(text):
    return [re.sub(r" \(\d+s\)$", "", line) for line in text.splitlines()]


def test_printout_matches_the_script_given_equal_predictions(jax_script,
                                                             monkeypatch):
    make_pipeline, assemble = _stand_ins()
    monkeypatch.setattr(jax_script, "trainer", types.SimpleNamespace(
        TrainConfig=lambda: None, create_state=lambda cfg: None,
        restore_checkpoint=lambda state, d: types.SimpleNamespace(
            step=43100)))
    monkeypatch.setattr(jax_script, "make_infer_pipeline", make_pipeline)
    monkeypatch.setattr(jax_script, "assemble_batch", assemble)
    monkeypatch.setattr(sys, "argv", ["cross_engine_eval.py", "16"])
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        jax_script.main()

    make_pipeline, assemble = _stand_ins()
    monkeypatch.setattr(ce, "load_weights", lambda *a, **k: (
        torch.nn.Linear(1, 1), 43100))
    monkeypatch.setattr(ce, "make_infer_pipeline", make_pipeline)
    monkeypatch.setattr(ce, "assemble_batch", assemble)
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        res = ce.main(["16", "--device", "cpu"])
    assert _strip_seconds(got.getvalue()) == \
        _strip_seconds(want.getvalue())
    assert len(got.getvalue().splitlines()) == 8
    assert res["a"].truths == res["b"].truths
    assert res["a"].report.n == 16


def test_evaluate_refuses_a_partial_batch():
    pools = {"a": [None] * 3, "b": [None] * 3}
    with pytest.raises(ValueError, match="whole number"):
        ce.evaluate(torch.nn.Linear(1, 1), pools, batch=2)


def test_main_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ce.main(["16"])
