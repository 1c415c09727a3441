"""eval/degraded_bench.py against the JAX package's scripts/degraded_bench.py,
on the CPU.

  * VARIANTS: the script's names and binarize thresholds, in order;
  * the held-out stream (`generate_samples(n, 0)`, the first accepted
    samples of random.Random(0)) for n=4: SMILES, label strings and drawings bit-equal (one Pillow here for
    both sides);
  * every variant's transformed image and its bits packed at the
    variant's threshold bit-equal to the script's transform and the JAX
    package's pack_images;
  * the printout of main() equal to the script's main() line for line
    (the seconds column aside) when both serve the same predictions: the
    weights, the serving pipeline and the assembler are replaced on both
    sides by the same stand-ins, so the stream, the pipelines built (one
    per threshold), the scoring and the table are the entry points' own;
  * one run of the port's sweep on the CPU with the snapshot in f32, 2
    images and 2 variants (both thresholds): the header and a row per
    variant, and each variant's first batch equal to make_infer_pipeline
    at its threshold called directly;
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

from abcnet_tpu_torch.data.generate import generate_samples
from abcnet_tpu_torch.data.pipeline import pack_images
from abcnet_tpu_torch.eval import degraded_bench as db
from abcnet_tpu_torch.infer.decode import make_infer_pipeline
from abcnet_tpu_torch.models.weights import load_snapshot
from torch_parity import REPO, SNAPSHOT

NAMES = [name for name, _, _ in db.VARIANTS]


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_degraded_bench", os.path.join(REPO, "scripts",
                                           "degraded_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def held_out4():
    return generate_samples(4, 0)


def test_variants_match_the_script(jax_script):
    assert [(n, t) for n, _, t in db.VARIANTS] == \
        [(n, t) for n, _, t in jax_script.VARIANTS]
    assert db.BATCH == jax_script.BATCH


def test_held_out_stream_matches_jax(jax_script, held_out4):
    rng = random.Random(0)
    want = []
    while len(want) < 4:
        s = jax_script.generate_sample(rng)
        if s is not None:
            want.append(s)
    for g, w in zip(held_out4, want):
        assert (g.smiles, g.atoms_string, g.bonds_string) == \
            (w.smiles, w.atoms_string, w.bonds_string)
        np.testing.assert_array_equal(g.image, w.image)


@pytest.mark.parametrize("name", NAMES)
def test_variant_image_and_bits_match_jax(jax_script, held_out4, name):
    from abcnet_tpu.data.pipeline import pack_images as jax_pack_images

    i = NAMES.index(name)
    _, fn, thr = db.VARIANTS[i]
    _, jfn, jthr = jax_script.VARIANTS[i]
    got = np.stack([fn(s.image) for s in held_out4[:2]])
    want = np.stack([jfn(s.image) for s in held_out4[:2]])
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pack_images(got, thr),
                                  jax_pack_images(want, jthr))


def _stand_ins(truths):
    """A serving pipeline that hands its images on, and an assembler that
    answers by call (one a variant at n = 16) and row: the truth, no
    answer, or, once a call, a wrong molecule (a wrong pair costs the
    scorer a tautomer search, so there are few)."""
    calls = [0]

    def make_pipeline(*args, threshold):
        make_pipeline.thresholds.append(threshold)
        return lambda imgs: {"images": np.asarray(imgs)}
    make_pipeline.thresholds = []

    def assemble(peaks):
        c = calls[0]
        calls[0] += 1
        return ["CCO" if r == c % len(truths) else
                None if (r + c) % 4 == 1 else truths[r]
                for r in range(len(peaks["images"]))]
    return make_pipeline, assemble


def _strip_seconds(text):
    return [re.sub(r"   \(\d+s\)$", "", line)
            for line in text.splitlines()]


def test_table_matches_the_script_given_equal_predictions(jax_script,
                                                          monkeypatch):
    truths = [s.smiles for s in generate_samples(16, 0)]
    make_pipeline, assemble = _stand_ins(truths)
    jax_thresholds = make_pipeline.thresholds

    fake_trainer = types.SimpleNamespace(
        TrainConfig=lambda: None, create_state=lambda cfg: None,
        restore_checkpoint=lambda state, d: types.SimpleNamespace(
            step=43100))
    monkeypatch.setattr(jax_script, "trainer", fake_trainer)
    monkeypatch.setattr(jax_script, "make_infer_pipeline", make_pipeline)
    monkeypatch.setattr(jax_script, "assemble_batch", assemble)
    monkeypatch.setattr(sys, "argv", ["degraded_bench.py", "16"])
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        jax_script.main()

    make_pipeline, assemble = _stand_ins(truths)
    monkeypatch.setattr(db, "load_weights", lambda *a, **k: (
        torch.nn.Linear(1, 1), 43100))
    monkeypatch.setattr(db, "make_infer_pipeline", make_pipeline)
    monkeypatch.setattr(db, "assemble_batch", assemble)
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        rows = db.main(["16", "--device", "cpu"])
    assert _strip_seconds(got.getvalue()) == \
        _strip_seconds(want.getvalue())
    assert len(_strip_seconds(want.getvalue())) == 2 + len(NAMES)
    assert [r.name for r in rows] == NAMES
    assert make_pipeline.thresholds == jax_thresholds == [0.2, 0.6]
    _, replay = _stand_ins(truths)
    assert [r.preds for r in rows] == [
        replay({"images": np.zeros((16, 1))}) for _ in rows]


def test_sweep_runs_on_the_cpu(held_out4):
    model, _ = load_snapshot(SNAPSHOT, device="cpu")
    variants = [v for v in db.VARIANTS
                if v[0] in ("clean", "gray_scan_thr0.2")]
    samples = held_out4[:2]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = db.sweep(model, samples, variants, batch=2)
    lines = buf.getvalue().splitlines()
    assert lines[0] == db.header() == (
        "variant                      exact exact_noniso    dice  decode")
    assert len(lines) == 3
    for line, (name, fn, thr), r in zip(lines[1:], variants, rows):
        assert re.fullmatch(
            rf"{re.escape(name)} +\d\.\d{{4}} +\d\.\d{{4}} +\d\.\d{{4}} "
            rf"+\d\.\d{{4}}   \(\d+s\)", line), line
        assert r.threshold == thr and r.report.n == 2
        want = make_infer_pipeline(model, "cpu", threshold=thr)(
            np.stack([fn(s.image) for s in samples]))
        assert sorted(want) == sorted(r.first_peaks)
        for k in want:
            np.testing.assert_array_equal(r.first_peaks[k], want[k],
                                          err_msg=k)


def test_sweep_refuses_a_partial_batch():
    with pytest.raises(ValueError, match="whole number"):
        db.sweep(torch.nn.Linear(1, 1), [None] * 3, batch=2)


def test_main_refuses_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        db.main(["16"])
