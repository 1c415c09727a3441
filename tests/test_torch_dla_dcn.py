"""CenterNet's DLA-34 + DCN (models/dla_dcn.py) served by the port, on the
CPU at 128x128 or smaller, float32, on weights of the benchmark's recipe
(benchmark/dla_weights.py: seeded He-normal kernels, the offset / mask
convs included, BatchNorm recalibrated on four crops of the frozen pool,
the heatmap biases matched to the production snapshot's median peak count
over eight, with the configuration's floor of peaks on each):

  * against the plain reference (benchmark/reference/dla_dcn.py): every
    head's logits and the features within FWD_ATOL, the sparse
    pipeline's peak dict equal to the reference decode's (integers exact,
    floats within FLOAT_ATOL), the sparse heads at peak cells equal to the
    dense heads there;
  * the port's plain deformable op (ops/deform_conv.py) against the
    reference's site, written apart from it, with offsets that put the
    samples on integer points, in (-1, 0), beyond -1 and in (H - 1, H),
    and with random per-pixel offsets; zero offsets with mask 1 equal
    F.conv2d;
  * a snapshot round-trip through save_snapshot and load_weights gives
    the DLA model back, every tensor equal;
  * a 2-image make_infer_pipeline run whose SMILES the frozen assembler
    spells the same from its peaks;
  * the recipe's heatmap bias on drawings whose levels spread more than
    their peaks: the median match hits its target, and the floor gives
    every drawing its peaks, the last one the margin above the threshold;
  * the cell's controls (no offsets, no masks, float8 samples and carry)
    fail the cell's comparison, the program passes it;
  * the parameter count at published widths, the model's and the
    reference's, and benchmark/counts_dla.py against FlopCounterMode and
    the deformable sites the model runs;
  * a profiled loop records 16 `dcn` spans and `dcn_sites` a batch;
  * the cell's kind exits at once on a program without the model;
  * the fused sparse-head bundles of UNet and UNetCBAM, and their
    outputs, equal bit for bit the ones computed from their OutConv
    modules directly (the bundle's generalisation to heads without a
    BatchNorm leaves them as they were).

Tolerances, each the float32 orders of two implementations:
  * FWD_ATOL 1e-4 on the base's six levels (measured at most 5.6e-5 at
    level5, on values up to 8.8), as tests/test_torch_cbam_serving.py;
  * HEAD_ATOL 5e-3 on the features and every head's logits (measured at
    most 1.7e-3, on logits up to 7.4): behind the base sit the 16
    deformable sites, and each samples at offsets that carry the offset
    conv's order error, which moves a sample by that error times the
    feature map's local slope; BatchNorm, recalibrated on four crops,
    scales it up between sites. One site alone on one input agrees to
    2e-6;
  * DCN_ATOL 1e-5 on a single site at unit-scale inputs (the port's one
    GEMM over 9 C columns a pixel against the reference's nine per-tap
    contractions);
  * FLOAT_ATOL 2e-3 on peak floats (scores, sub-cell offsets, deltas),
    which the decode computes from logits within HEAD_ATOL: a score moves
    by at most a quarter of its logit's gap, a parabolic sub-cell offset
    by the gap over the peak's curvature (measured at most 2.3e-4).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from abcnet_tpu_torch import __main__ as cli
from abcnet_tpu_torch.infer import decode
from abcnet_tpu_torch.models.dla_dcn import DeformConv, DLASeg
from abcnet_tpu_torch.models.unet import UNet, param_count
from abcnet_tpu_torch.models.unet_cbam import UNetCBAM
from abcnet_tpu_torch.models.weights import load_weights, save_snapshot
from abcnet_tpu_torch.ops import deform_conv as dc
from abcnet_tpu_torch.utils import profiling
from torch_parity import REPO, SNAPSHOT

sys.path.insert(0, REPO)

from benchmark import cbam_weights, check, counts_dla, dla_weights  # noqa: E402
from benchmark import harness, pool  # noqa: E402
from benchmark.kinds import convert, convert_dla  # noqa: E402
from benchmark.reference import decode as ref_decode  # noqa: E402
from benchmark.reference import dla_dcn as ref_dla  # noqa: E402

SIZE = 128
FWD_ATOL = 1e-4
HEAD_ATOL = 5e-3
DCN_ATOL = 1e-5
FLOAT_ATOL = 2e-3
CELL = "dla34_dcn_bf16.convert_b64_dla"
CFG = harness.load_json(os.path.join(REPO, "benchmark", "configs",
                                     "dla34_dcn_bf16.json"))


@pytest.fixture(scope="module")
def crops():
    """Centre crops of 16 pool drawings (both engines)."""
    images = pool.load_images()
    return np.ascontiguousarray(images[::64, 192:320, 192:320])


@pytest.fixture(scope="module")
def snapshot(crops, tmp_path_factory):
    """The recipe's snapshot (calibration: crops 0-3; peak counts over
    crops 4-11)."""
    root = tmp_path_factory.mktemp("dla")
    data, _ = dla_weights.make(CFG, crops[:4], crops[4:12], SNAPSHOT, "cpu")
    path = str(root / "data.npz")
    cbam_weights.write_npz(path, data)
    cfg = dict(CFG, weights_data=path)
    with open(cbam_weights.data_paths(cfg)[1], "w") as f:
        f.write(cbam_weights.sha256(path) + "\n")
    return dla_weights.build_snapshot(cfg, str(root))


@pytest.fixture(scope="module")
def model(snapshot):
    m, step = load_weights(snapshot, device="cpu", dtype=torch.float32)
    assert isinstance(m, DLASeg) and step == 0
    return m


def _nhwc(crops):
    return ref_decode.binarize(crops, "cpu").permute(0, 2, 3, 1)


def test_port_matches_the_plain_reference(model, snapshot, crops):
    x = crops[[0, 5]]
    w = ref_dla.load_snapshot(snapshot, "cpu")
    ink = ref_decode.binarize(x, "cpu")
    ref = ref_dla.forward(w, ink)
    with torch.no_grad():
        heads, feats = model(_nhwc(x), return_features=True)
        levels = model.base(ink, torch.float32)
    for got, want in zip(levels, ref_dla._Forward(w, None, False).base(ink)):
        torch.testing.assert_close(got, want, rtol=0, atol=FWD_ATOL)
    assert sorted(heads) == sorted(ref_dla.HEADS)
    for k, v in heads.items():
        assert v.dtype == torch.float32
        torch.testing.assert_close(v.permute(0, 3, 1, 2), ref[k], rtol=0,
                                   atol=HEAD_ATOL)
    torch.testing.assert_close(feats.permute(0, 3, 1, 2), ref["features"],
                               rtol=0, atol=HEAD_ATOL)
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
    # the sparse heads at peak cells are the dense heads there
    g = feats.shape[1]
    bundles = decode.sparse_heads(model, torch.float32)
    for name, names in (("atom", ("atom_type", "atom_charge", "atom_hs")),
                        ("bond", ("bond_omega", "bond_type", "bond_rho"))):
        a = heads["atom_target" if name == "atom" else "bond_target"]
        _, idx = decode._stable_topk(a[..., 0].flatten(1), 16)
        r, c = idx // g, idx % g
        outs = decode.apply_heads_fused(bundles[name],
                                        decode.gather_windows(feats, r, c, 1))
        b = torch.arange(x.shape[0])[:, None]
        for h, v in zip(names, outs):
            torch.testing.assert_close(v, heads[h][b, r, c], rtol=0,
                                       atol=FWD_ATOL)


def _site_weights(ci, co, gen, om_bias=None):
    """A deformable site's weights, keyed as the reference reads them
    (prefix "s"), and its torch modules' tensors."""
    w = {"params/s/Conv_0/kernel": torch.randn(3, 3, ci, co, generator=gen)
         * (2 / (9 * ci)) ** 0.5,
         "params/s/Conv_0/bias": torch.randn(co, generator=gen) * 0.1,
         "params/s/Conv_1/kernel": torch.randn(3, 3, ci, 27, generator=gen)
         * (2 / (9 * ci)) ** 0.5,
         "params/s/Conv_1/bias": torch.randn(27, generator=gen),
         "params/s/BatchNorm_0/scale": 1 + 0.2 * torch.randn(co,
                                                            generator=gen),
         "params/s/BatchNorm_0/bias": 0.1 * torch.randn(co, generator=gen),
         "batch_stats/s/BatchNorm_0/mean": 0.3 * torch.randn(co,
                                                            generator=gen),
         "batch_stats/s/BatchNorm_0/var": 0.5 + torch.rand(co, generator=gen)}
    if om_bias is not None:
        w["params/s/Conv_1/kernel"][..., :18] = 0
        w["params/s/Conv_1/bias"][:18] = om_bias
    return w


def _port_site(w, x):
    om = F.conv2d(x, w["params/s/Conv_1/kernel"].permute(3, 2, 0, 1),
                  w["params/s/Conv_1/bias"], padding=1)
    return dc.deform_conv_bn_act_eval_plain(
        x, om, w["params/s/Conv_0/kernel"].permute(3, 2, 0, 1),
        w["params/s/Conv_0/bias"], w["batch_stats/s/BatchNorm_0/mean"],
        w["batch_stats/s/BatchNorm_0/var"], w["params/s/BatchNorm_0/scale"],
        w["params/s/BatchNorm_0/bias"], ref_dla.EPS, "relu")


H = 7
# (case, dy, dx): uniform offsets a tap (the offset conv's kernel zero,
# its bias these), then random per-pixel offsets
CASES = [("integer", 1.0, -2.0), ("in_minus_one_to_zero", -0.7, -0.35),
         ("beyond_minus_one", -1.3, -2.6), ("in_last_cell", 0.3, 0.85),
         ("past_the_edge", 1.6, 2.2), ("random", None, None)]


@pytest.mark.parametrize("case,dy,dx", CASES, ids=[c[0] for c in CASES])
def test_plain_op_matches_the_reference_site(case, dy, dx):
    gen = torch.Generator().manual_seed(7)
    om_bias = None
    if dy is not None:
        om_bias = torch.tensor([dy, dx] * 9)
    w = _site_weights(16, 24, gen, om_bias)
    x = torch.rand(2, 16, H, H + 2, generator=gen)
    with torch.no_grad():
        got = _port_site(w, x)
        want = ref_dla._Forward(w, None, False).dcn("s", x)
    torch.testing.assert_close(got, want, rtol=0, atol=DCN_ATOL)
    if dy is not None:
        # the samples land where the case says: at least one tap of the
        # border rows reads a point of the named kind
        ys = torch.arange(H)[:, None] - 1 + torch.arange(3)[None] + dy
        frac = ys - ys.floor()
        assert {"integer": (frac == 0).all(),
                "in_minus_one_to_zero": ((ys > -1) & (ys < 0)).any(),
                "beyond_minus_one": (ys <= -1).any(),
                "in_last_cell": ((ys > H - 1) & (ys < H)).any(),
                "past_the_edge": (ys >= H).any()}[case]


def test_zero_offsets_with_mask_one_equal_conv2d():
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 16, 9, 11, generator=gen)
    weight = torch.randn(24, 16, 3, 3, generator=gen) / 12
    bias = torch.randn(24, generator=gen)
    om = torch.cat([torch.zeros(2, 18, 9, 11),
                    torch.full((2, 9, 9, 11), 40.0)], 1)
    got = dc.deform_conv_plain(x, om, weight, bias)
    torch.testing.assert_close(got, F.conv2d(x, weight, bias, padding=1),
                               rtol=0, atol=DCN_ATOL)
    # through the eval-mode op (the CPU takes the plain columns)
    cols = dc.modulated_columns(x, om)
    torch.testing.assert_close(cols, dc.modulated_columns_plain(x, om),
                               rtol=0, atol=0)


def test_snapshot_round_trip_gives_the_dla_model(model, tmp_path):
    path = save_snapshot(model, str(tmp_path / "s.npz"), step=5)
    back, step = load_weights(path, device="cpu", dtype=torch.float32)
    assert type(back) is DLASeg and step == 5
    a, b = model.state_dict(), back.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_pipeline_smiles_are_the_frozen_assemblers(model, crops):
    run = decode.make_infer_pipeline(model, "cpu")
    x = [crops[0], crops[10]]
    smiles = cli.img2smiles_loop(run, x, 2, log_every=0)
    peaks = run(np.stack(x))
    assemble = check.frozen_assembler()
    assert [assemble(peaks, i) for i in range(2)] == smiles
    assert any(smiles)


@pytest.mark.parametrize("floor,margin", [(2, 0.1), (1, 0.0), (3, 0.5)])
def test_heatmap_bias_keeps_every_drawing_its_floor(floor, margin):
    # drawings whose levels spread far more than their maxima within one:
    # the median match alone leaves the lowest with no peak
    gen = torch.Generator().manual_seed(floor)
    level = torch.linspace(-6.0, 3.0, 33)[:, None]
    maxima = (level - torch.rand(33, 128, generator=gen).sort(
        1, descending=True)[0]).double()
    target = 20.0
    median = dla_weights.match_median_shift(maxima, target)
    assert dla_weights.median_count(maxima, median) == target
    assert (dla_weights.peak_counts(maxima, median) == 0).any()
    shift = max(median, dla_weights.floor_shift(maxima, floor, margin))
    assert dla_weights.peak_counts(maxima, shift).min() >= floor
    assert float((maxima[:, floor - 1] + shift).min()) == pytest.approx(
        ref_decode.LOGIT_THRESHOLD + margin)
    assert dla_weights.median_count(maxima, shift) >= target


@pytest.mark.parametrize("mode,correct", [("program", True),
                                          ("no_offset", False),
                                          ("no_mask", False),
                                          ("fp8", False)])
def test_controls_fail_the_cell_comparison(snapshot, crops, mode, correct):
    cfg = dict(CFG, weights=snapshot)
    if mode == "program":
        program = convert.Program(dict(cfg, dtype="float32"),
                                  {"processes": 0}, None, "cpu")
    else:
        program = convert_dla.ControlProgram(cfg, mode, "cpu")
    x = list(crops[12:16])
    loop = convert.Loop(program, keep=range(2))
    loop(x, 2)
    batches = [{"images": np.stack(x[2 * i:2 * i + 2]), **loop.kept[i]}
               for i in range(2)]
    nums = convert_dla.compare(cfg, None, batches, "cpu")
    checks = check.judge(nums, harness.limits(CELL))
    assert check.passed(checks) == correct, checks


def test_parameter_count_at_published_widths(model):
    shapes = ref_dla.param_shapes()
    n = sum(int(np.prod(s)) for s in shapes.values())
    assert param_count(model) == n == CFG["parameters"] == 20_520_053
    assert [tuple(x) for x in CFG["tree_levels"]] == \
        [tuple(t) for t in ref_dla.TREES]
    assert (tuple(CFG["levels"]), tuple(CFG["channels"])) == \
        (ref_dla.LEVELS, ref_dla.CHANNELS)


def test_counts_match_the_model(model):
    cfg = dict(CFG, image_size=SIZE)
    x = torch.zeros(1, SIZE, SIZE, 1)
    seen = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: seen.append((out.shape[2],
                                           inp[0].shape[1],
                                           out.shape[1])))
        for m in model.modules() if isinstance(m, DeformConv)]
    try:
        with torch.no_grad(), FlopCounterMode(display=False) as fc:
            model(x, dense_heads=decode.DENSE_HEADS_SPARSE_MODE,
                  return_features=True)
    finally:
        for h in hooks:
            h.remove()
    assert fc.get_total_flops() == counts_dla.dense_ops(
        cfg, cfg["heatmap_heads"])
    assert seen == [s[1:] for s in counts_dla.sites(cfg)]
    # at the configuration's size: 59.7 GFLOP an image, of which the
    # deformable contractions 14.2 and their offset convs 4.65
    assert round(counts_dla.dense_ops(CFG, CFG["heatmap_heads"]) / 1e9,
                 1) == 59.7
    assert round(counts_dla.dense_ops(CFG, None, ("dcn",)) / 1e9, 1) == 14.2
    assert round(counts_dla.dense_ops(CFG, None, ("offset",)) / 1e9,
                 2) == 4.65


def test_profiled_loop_records_the_sites(model, crops):
    from torch.profiler import ProfilerActivity, profile

    run = decode.make_infer_pipeline(model, "cpu")
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        cli.img2smiles_loop(run, list(crops[12:16]), 2, log_every=0)
    counters = profiling.counters()
    assert len(counters) == 2
    assert all(c["dcn_sites"] == 16 for c in counters.values())
    spans = [s for s in profiling.spans() if s.name == "dcn"]
    assert len(spans) == 32 and all(s.parent == "enqueue" for s in spans)
    profiling.clear()


def test_kind_exits_at_once_without_the_model(monkeypatch):
    import importlib.util

    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    with pytest.raises(SystemExit, match="no abcnet_tpu_torch.models"):
        convert_dla.run(None)


def test_reference_imports_nothing_of_the_program():
    probe = ("import json, sys\n"
             "sys.path.insert(0, 'benchmark')\n"
             "import benchmark.reference.dla_dcn, benchmark.dla_weights\n"
             "import benchmark.counts_dla, benchmark.kinds.convert_dla\n"
             "print(json.dumps(sorted({m.split('.')[0] "
             "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "abcnet_tpu",
                        "abcnet_tpu_torch"}, names


def _outconv_bundle(model, names):
    """The bundle of OutConv heads as the sparse path built it before
    heads without a BatchNorm: straight from the modules."""
    heads = [model.head(n) for n in names]
    k0 = torch.cat([h.conv0.weight.detach().permute(2, 3, 1, 0)
                    for h in heads], dim=-1)
    return {
        "k0": k0.reshape(-1, k0.shape[-1]),
        "b0": torch.cat([h.conv0.bias.detach() for h in heads]),
        "scale": torch.cat([h.bn0.weight.detach() for h in heads]),
        "bias": torch.cat([h.bn0.bias.detach() for h in heads]),
        "mean": torch.cat([h.bn0.running_mean for h in heads]),
        "var": torch.cat([h.bn0.running_var for h in heads]),
        "k1": torch.block_diag(*[h.conv1.weight.detach()[:, :, 0, 0].t()
                                 for h in heads]),
        "b1": torch.cat([h.conv1.bias.detach() for h in heads])}


@pytest.mark.parametrize("cls", [UNet, UNetCBAM], ids=lambda c: c.__name__)
def test_unet_head_bundles_are_unchanged(cls):
    torch.manual_seed(11)
    model = cls(dtype=torch.bfloat16).eval()
    for m in model.modules():
        if hasattr(m, "running_mean"):
            m.running_mean.normal_(0, 0.3)
            m.running_var.uniform_(0.5, 2.0)
            m.weight.data.normal_(1, 0.2)
            m.bias.data.normal_(0, 0.1)
    win = torch.randn(2, 5, 3, 3, 128)
    for names in (("atom_type", "atom_charge", "atom_hs"),
                  ("bond_omega", "bond_type", "bond_rho")):
        widths = [model.heads[model.head_names.index(n)] for n in names]
        fz = decode.fuse_head_params(model, names, widths, torch.bfloat16)
        want = _outconv_bundle(model, names)
        assert set(fz) == set(want) | {"widths"}
        assert fz["widths"] == tuple(widths)
        for k, v in want.items():
            dt = torch.bfloat16 if k in ("k0", "b0", "k1", "b1") \
                else torch.float32
            assert torch.equal(fz[k], v.to(dt)), k
        got = decode.apply_heads_fused(fz, win, torch.bfloat16)
        x = win.to(torch.bfloat16).reshape(10, -1) @ want["k0"].to(
            torch.bfloat16)
        x = (x + want["b0"].to(torch.bfloat16)).float()
        x = (x - want["mean"]) * torch.rsqrt(want["var"] + 1e-5)
        x = F.leaky_relu(x * want["scale"] + want["bias"], 0.01).to(
            torch.bfloat16)
        out = (x @ want["k1"].to(torch.bfloat16)
               + want["b1"].to(torch.bfloat16)).float()
        for g, w_ in zip(got, out.reshape(2, 5, -1).split(widths, -1)):
            assert torch.equal(g, w_)
