"""The CBAM U-Net (models/unet_cbam.py) served by the port, on the CPU at
128x128, float32, on weights of the benchmark's recipe
(benchmark/cbam_weights.py: seeded He-normal kernels, BatchNorm
recalibrated on four crops of the frozen pool, the heatmap biases
matched to the production snapshot's peak counts over eight):

  * against the plain reference (benchmark/reference/unet_cbam.py):
    heatmaps and features within FWD_ATOL, the sparse pipeline's peak
    dict equal to the reference decode's (integers exact, floats within
    FLOAT_ATOL);
  * against the JAX package's module, on 64x64 crops: the serving
    contract's heatmaps equal its dense heads, and the sparse heads at
    the peak cells equal its dense heads there;
  * `img2smiles --ckpt <seeded snapshot>` end to end, through the CLI's
    entry point and make_infer_pipeline (drawings loaded as 128x128
    crops, where the CLI resizes to 512x512: the same path at a size a
    test can hold);
  * the recipe twice gives a data file with the same sha256;
  * the two controls of the benchmark cell (the reference without the
    channel gate's max branch; gates and carry in float8 e4m3) fail the
    cell's comparison, the program passes it;
  * benchmark/counts_cbam.py against a count from the model's own
    modules: FlopCounterMode's operations and the gated tensors' bytes;
  * a profiled conversion loop records 13 `cbam` spans and `cbam_gates`
    a batch, no device event named `abcnet.*`, and a device span's
    events resolve into its `<name>_device_us` counter;
  * the reference, the recipe and the counts import nothing of the
    program, of JAX or of the JAX package;
  * the int8 backbone refuses the model with an error that names it.

Tolerances: FWD_ATOL 1e-4 on logits and features, the float32
convolution order of two implementations (tests/test_torch_variants.py
holds the JAX comparison to the same); FLOAT_ATOL 2e-4 on peak floats
(scores, sub-cell offsets, deltas), as tests/test_torch_slice.py.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from abcnet_tpu.models.unet_cbam import UNetCBAM as FlaxCBAM
from abcnet_tpu_torch import __main__ as cli
from abcnet_tpu_torch.data import pipeline
from abcnet_tpu_torch.infer import decode
from abcnet_tpu_torch.infer.quant import prepare_quant
from abcnet_tpu_torch.models.unet_cbam import DoubleConvCBAM, UNetCBAM
from abcnet_tpu_torch.models.weights import _unflatten, load_weights
from abcnet_tpu_torch.utils import profiling
from torch_parity import REPO, SNAPSHOT

sys.path.insert(0, REPO)

from benchmark import cbam_weights, check, counts_cbam, harness  # noqa: E402
from benchmark import pool  # noqa: E402
from benchmark.kinds import convert, convert_seeded  # noqa: E402
from benchmark.reference import decode as ref_decode  # noqa: E402
from benchmark.reference import unet_cbam as ref_cbam  # noqa: E402

SIZE = 128
FWD_ATOL = 1e-4
FLOAT_ATOL = 2e-4
CELL = "unet_cbam_bf16.convert_b64_seeded"
CFG = harness.load_json(os.path.join(REPO, "benchmark", "configs",
                                     "unet_cbam_bf16.json"))


@pytest.fixture(scope="module")
def crops():
    """Centre crops of 16 pool drawings (both engines)."""
    images = pool.load_images()
    return np.ascontiguousarray(images[::64, 192:320, 192:320])


def _make(crops, path):
    """The recipe's data file at `path` (calibration: crops 0-3; peak
    counts over crops 4-11); the configuration that names it."""
    data, _ = cbam_weights.make(CFG, crops[:4], crops[4:12], SNAPSHOT,
                                "cpu")
    cbam_weights.write_npz(path, data)
    cfg = dict(CFG, weights_data=path)
    with open(cbam_weights.data_paths(cfg)[1], "w") as f:
        f.write(cbam_weights.sha256(path) + "\n")
    return cfg


@pytest.fixture(scope="module")
def snapshot(crops, tmp_path_factory):
    root = tmp_path_factory.mktemp("cbam")
    cfg = _make(crops, str(root / "data.npz"))
    return cbam_weights.build_snapshot(cfg, str(root))


@pytest.fixture(scope="module")
def model(snapshot):
    m, step = load_weights(snapshot, device="cpu", dtype=torch.float32)
    assert isinstance(m, UNetCBAM) and step == 0
    return m


def _nhwc(crops):
    return ref_decode.binarize(crops, "cpu").permute(0, 2, 3, 1)


def test_port_matches_the_plain_reference(model, snapshot, crops):
    x = crops[12:16]
    ref = ref_cbam.forward(ref_cbam.load_snapshot(snapshot, "cpu"),
                           ref_decode.binarize(x, "cpu"))
    with torch.no_grad():
        heads, feats = model(_nhwc(x), dense_heads=decode
                             .DENSE_HEADS_SPARSE_MODE, return_features=True)
    assert sorted(heads) == sorted(decode.DENSE_HEADS_SPARSE_MODE)
    for k, v in heads.items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(v.permute(0, 3, 1, 2), ref[k], rtol=0,
                                   atol=FWD_ATOL)
    torch.testing.assert_close(feats.permute(0, 3, 1, 2), ref["features"],
                               rtol=0, atol=FWD_ATOL)
    got = decode.make_infer_pipeline(model, "cpu")(x)
    want, _ = ref_decode.decode(ref)
    assert got["atom_valid"].any() and got["bond_valid"].any()
    assert set(got) <= set(want)
    for k, v in got.items():
        if np.issubdtype(v.dtype, np.floating):
            np.testing.assert_allclose(v, want[k], rtol=0, atol=FLOAT_ATOL,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_contract_matches_the_jax_module(model, snapshot, crops):
    z = np.load(snapshot)
    tree = _unflatten({k: z[k] for k in z.files if k != "__step__"})
    x = _nhwc(np.ascontiguousarray(crops[12:14, 32:96, 32:96]))
    want = jax.jit(lambda v, a: FlaxCBAM().apply(v, a, train=False))(
        tree, jnp.asarray(x.numpy()))
    g = x.shape[1] // 4
    with torch.no_grad():
        heads, feats = model(x, dense_heads=decode.DENSE_HEADS_SPARSE_MODE,
                             return_features=True)
        for k, v in heads.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]),
                                       rtol=0, atol=FWD_ATOL, err_msg=k)
        bundles = decode.sparse_heads(model, torch.float32)
        for name, bundle in (("atom", ("atom_type", "atom_charge",
                                       "atom_hs")),
                             ("bond", ("bond_omega", "bond_type",
                                       "bond_rho"))):
            a = heads["atom_target" if name == "atom" else "bond_target"]
            _, idx = decode._stable_topk(a[..., 0].flatten(1), 16)
            r, c = idx // g, idx % g
            outs = decode.apply_heads_fused(
                bundles[name], decode.gather_windows(feats, r, c, 1))
            b = torch.arange(x.shape[0])[:, None]
            for h, v in zip(bundle, outs):
                np.testing.assert_allclose(
                    v.numpy(), np.asarray(want[h])[b, r, c], rtol=0,
                    atol=FWD_ATOL, err_msg=h)


def test_img2smiles_serves_a_seeded_cbam_snapshot(model, snapshot, crops,
                                                  tmp_path, monkeypatch,
                                                  capsys):
    import csv

    from abcnet_tpu_torch.data import raster
    from abcnet_tpu_torch.data.generate import write_dataset_csv

    (tmp_path / "images").mkdir()
    rows = []
    for i in range(3):
        raster.imwrite(str(tmp_path / f"images/{i}.png"), crops[12 + i])
        rows.append({"Smiles": "C", "ID": str(i), "path": f"images/{i}.png",
                     "atoms_string": "", "bonds_string": ""})
    write_dataset_csv(str(tmp_path / "dataset.csv"), rows)
    served, make = [], decode.make_infer_pipeline

    def recording(m, *a, **kw):
        served.append(type(m).__name__)
        return make(m, *a, **kw)

    def read_crops(csv_path):
        return ([raster.imread_gray(str(tmp_path / r["path"])) for r in rows],
                [r["Smiles"] for r in rows])

    monkeypatch.setattr(decode, "make_infer_pipeline", recording)
    monkeypatch.setattr(pipeline, "load_image_csv", read_crops)
    cli.main(["img2smiles", "--data", str(tmp_path), "--ckpt", snapshot,
              "--out", str(tmp_path / "results.csv"), "-b", "2",
              "--dtype", "float32", "--device", "cpu"])
    assert f"weights: {snapshot} (step 0)" in capsys.readouterr().out
    assert served == ["UNetCBAM"]
    with open(tmp_path / "results.csv", newline="") as f:
        got = [r["smiles_pred"] for r in csv.DictReader(f)]
    want = cli.img2smiles_loop(make(model, "cpu"), list(crops[12:15]), 2,
                               log_every=0)
    assert got == ["" if p is None else p for p in want]
    assert any(got)


def test_weights_recipe_is_deterministic(crops, tmp_path):
    a = _make(crops, str(tmp_path / "a.npz"))
    b = _make(crops, str(tmp_path / "b.npz"))
    assert cbam_weights.sha256(a["weights_data"]) == cbam_weights.sha256(
        b["weights_data"])
    with np.load(a["weights_data"]) as z:
        assert any(k.startswith("batch_stats/") for k in z.files)
        for h in cbam_weights.HEATMAPS:
            assert float(z[f"info/{h}/seeded_peaks"]) == pytest.approx(
                float(z[f"info/{h}/production_peaks"]), rel=0.1)


@pytest.mark.parametrize("mode,correct", [("program", True),
                                          ("no_max", False),
                                          ("fp8", False)])
def test_controls_fail_the_cell_comparison(snapshot, crops, mode, correct):
    cfg = dict(CFG, weights=snapshot)
    if mode == "program":
        program = convert.Program(dict(cfg, dtype="float32"), {"processes":
                                                               0}, None,
                                  "cpu")
    else:
        program = convert_seeded.ControlProgram(cfg, mode, "cpu")
    x = list(crops[12:16])
    loop = convert.Loop(program, keep=range(2))
    loop(x, 2)
    batches = [{"images": np.stack(x[2 * i:2 * i + 2]), **loop.kept[i]}
               for i in range(2)]
    nums = convert_seeded.compare(cfg, None, batches, "cpu")
    checks = check.judge(nums, harness.limits(CELL))
    assert check.passed(checks) == correct, checks


def test_counts_match_the_model(model):
    cfg = dict(CFG, image_size=SIZE)
    x = torch.zeros(1, SIZE, SIZE, 1)
    sizes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: sizes.append(out.numel()))
        for m in model.modules() if isinstance(m, DoubleConvCBAM)]
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            model(x, dense_heads=decode.DENSE_HEADS_SPARSE_MODE,
                  return_features=True)
    finally:
        for h in hooks:
            h.remove()
    assert fc.get_total_flops() == counts_cbam.dense_ops(
        cfg, cfg["heatmap_heads"])
    assert len(sizes) == counts_cbam.sites(cfg) == 13
    assert counts_cbam.gate_bytes(cfg, 1) == sum(4 * 2 * n for n in sizes)
    # at the configuration's own size: 14.83 GB and 101.4 GFLOP
    assert counts_cbam.gate_bytes(CFG, 64) == 14_831_058_944
    assert round(counts_cbam.dense_ops(CFG, CFG["heatmap_heads"]) / 1e9,
                 1) == 101.4


def test_profiled_loop_records_the_gates(model, crops):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run = decode.make_infer_pipeline(model, "cpu")
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cli.img2smiles_loop(run, list(crops[12:16]), 2, log_every=0)
    counters = profiling.counters()
    assert len(counters) == 2
    assert all(c["cbam_gates"] == 13 for c in counters.values())
    spans = [s for s in profiling.spans() if s.name == "cbam"]
    assert len(spans) == 26 and all(s.parent == "enqueue" for s in spans)
    names = [(e.name, e.device_type) for e in prof.events()]
    assert ("abcnet.cbam", DeviceType.CPU) in names
    assert not [n for n, d in names
                if n.startswith("abcnet.") and d != DeviceType.CPU]
    profiling.clear()

    class Event:
        def __init__(self, ms):
            self.ms = ms

        def elapsed_time(self, end):
            return end.ms - self.ms

    bid = profiling.RECORDER.new_batch()
    profiling.RECORDER.add_events(bid, "cbam", Event(1.0), Event(1.25))
    profiling.RECORDER.add_events(bid, "cbam", Event(2.0), Event(2.5))
    with profiling.batch(bid):
        profiling.resolve_device_spans()
        profiling.resolve_device_spans()
    assert profiling.counters()[bid] == {"cbam_device_us": 750}
    profiling.clear()
    with torch.no_grad():
        model(_nhwc(crops[12:13]))
    assert not profiling.counters() and not profiling.spans()


def test_reference_imports_nothing_of_the_program():
    import subprocess

    probe = ("import json, sys\n"
             "sys.path.insert(0, 'benchmark')\n"
             "import benchmark.reference.unet_cbam, benchmark.cbam_weights\n"
             "import benchmark.counts_cbam\n"
             "print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "abcnet_tpu",
                        "abcnet_tpu_torch"}, names


def test_int8_backbone_refuses_the_cbam_model(model):
    with pytest.raises(ValueError, match="UNetCBAM"):
        prepare_quant(model, torch.zeros(1, SIZE, SIZE, 1))
