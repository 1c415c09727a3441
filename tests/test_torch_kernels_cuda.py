"""The torch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one: a CUDA kernel has no CPU mode, and the plain versions are held to
abcnet_tpu on the CPU by tests/test_torch_unpack.py,
tests/test_torch_noise.py, tests/test_torch_peaks.py and
tests/test_torch_conv_s8.py. The file imports no JAX, so on the GPU
machine (which has none) it runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerance: bit-equality, scores and every index slot included.
"""

import pytest
import torch

import chip_smoke
from abcnet_tpu_torch.ops import peaks
from abcnet_tpu_torch.ops.noise import unpack_noise, unpack_noise_plain
from abcnet_tpu_torch.ops.peaks import (nms_topk, nms_topk_pair,
                                        nms_topk_plain)
from abcnet_tpu_torch.ops.unpack import unpack_bits, unpack_bits_plain
from torch_parity import NMS_CASES, cuda, packed_bits  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("kind", ["random", "zeros", "ones"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_unpack_kernel_matches_plain(cuda, kind, dtype):
    bits = torch.from_numpy(packed_bits(kind, 8)).to(cuda)
    before = unpack_bits.launches
    got = unpack_bits(bits, dtype)
    torch.cuda.synchronize()
    assert unpack_bits.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (8, 512, 512)
    assert torch.equal(got, unpack_bits_plain(bits, dtype))


def test_unpack_kernel_rejects_strided_input(cuda):
    bits = torch.zeros(2, 64, 512, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        unpack_bits(bits.transpose(1, 2))


@pytest.mark.parametrize("seed", [0, 43100, 2 ** 63 - 1])
@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_noise_kernel_matches_plain(cuda, dtype, b, seed):
    bits = torch.from_numpy(packed_bits("random", b)).to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(b)
    rates = torch.rand(b, 2, device=cuda, generator=gen) * \
        torch.tensor([0.002, 0.2], device=cuda)
    before = unpack_noise.launches
    got = unpack_noise(bits, rates, seed, dtype)
    torch.cuda.synchronize()
    assert unpack_noise.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, 512, 512)
    assert torch.equal(got, unpack_noise_plain(bits, rates, seed, dtype))
    # a seed held in device memory is the same seed
    dev_seed = torch.tensor([seed], dtype=torch.int64, device=cuda)
    assert torch.equal(got, unpack_noise(bits, rates, dev_seed, dtype))
    assert torch.equal(unpack_noise(bits, torch.zeros_like(rates), seed,
                                    dtype), unpack_bits(bits, dtype))


def test_noise_kernel_extreme_rates(cuda):
    """Rates the integer thresholds take apart: 0, 1 and above, negative,
    infinite and NaN, the smallest steps of a 24-bit uniform."""
    nan, inf = float("nan"), float("inf")
    rates = torch.tensor([[nan, 0.1], [0.1, nan], [-1.0, -0.5], [2.0, 0.0],
                          [0.5, inf], [inf, 0.25], [1.0, 1.0], [0.0, 1.0],
                          [2.0 ** -24, 2.0 ** -25], [1 - 2.0 ** -24, 2.0 ** -24],
                          [1.0, 0.5], [nan, nan]], device=cuda)
    bits = torch.from_numpy(packed_bits("random", len(rates))).to(cuda)
    for dtype in (torch.bfloat16, torch.float32):
        got = unpack_noise(bits, rates, 17, dtype)
        assert torch.equal(got, unpack_noise_plain(bits, rates, 17, dtype))
    assert got[3].all() and not got[1].any() and not got[6].any()


def test_noise_kernel_rejects_strided_input(cuda):
    bits = torch.zeros(2, 64, 512, dtype=torch.uint8, device=cuda)
    rates = torch.zeros(2, 2, device=cuda)
    with pytest.raises(ValueError):
        unpack_noise(bits.transpose(1, 2), rates, 0)
    with pytest.raises(ValueError):
        unpack_noise(bits, torch.zeros(2, 4, device=cuda)[:, ::2], 0)
    with pytest.raises(ValueError):
        unpack_noise(bits, rates.cpu(), 0)
    assert tuple(unpack_noise(bits[:0], rates[:0], 0).shape) == (0, 64, 4096)


@pytest.mark.parametrize("case", sorted(NMS_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nms_kernel_matches_plain(cuda, case, dtype):
    make, k, thr = NMS_CASES[case]
    m = torch.from_numpy(make()).to(cuda, dtype)
    before = nms_topk.launches
    s, i = nms_topk(m, k, thr)
    torch.cuda.synchronize()
    assert nms_topk.launches == before + 1
    ps, pi = nms_topk_plain(m, k, thr)
    assert torch.equal(s, ps) and torch.equal(i, pi)


@pytest.mark.parametrize("case", sorted(NMS_CASES))
@pytest.mark.parametrize("cluster", [1, 2, 8])
def test_nms_kernel_any_cluster_size(cuda, case, cluster):
    """The same slots whatever number of CTAs shares a map."""
    make, k, thr = NMS_CASES[case]
    m = torch.from_numpy(make()).to(cuda, torch.bfloat16)
    s, i = nms_topk(m, k, thr, cluster=cluster)
    ps, pi = nms_topk_plain(m, k, thr)
    assert torch.equal(s, ps) and torch.equal(i, pi)


@pytest.mark.parametrize("b", [1, 3, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nms_pair_kernel_matches_two_plain_calls(cuda, dtype, b):
    """Both heatmaps of a batch through one launch, K = 128 and 160."""
    gen = torch.Generator().manual_seed(b)
    a_map = (torch.randn(b, 128, 128, generator=gen) * 3).to(cuda, dtype)
    b_map = (torch.randn(b, 128, 128, generator=gen) - 4.5).to(cuda, dtype)
    before = nms_topk.launches
    (sa, ia), (sb, ib) = nms_topk_pair(a_map, 128, b_map, 160, -1.0)
    torch.cuda.synchronize()
    assert nms_topk.launches == before + 1
    pa, pb = nms_topk_plain(a_map, 128, -1.0), nms_topk_plain(b_map, 160, -1.0)
    assert torch.equal(sa, pa[0]) and torch.equal(ia, pa[1])
    assert torch.equal(sb, pb[0]) and torch.equal(ib, pb[1])
    assert int(torch.isfinite(sb).sum()) < sb.numel()     # exhausted slots


def test_nms_pair_kernel_rejects_unlike_maps(cuda):
    a = torch.zeros(2, 16, 16, device=cuda)
    with pytest.raises(ValueError):
        nms_topk_pair(a, 4, a[:, :8], 4, -1.0)
    with pytest.raises(ValueError):
        nms_topk_pair(a, 4, a.cpu(), 4, -1.0)
    with pytest.raises(ValueError):
        nms_topk(a.transpose(1, 2), 4, -1.0)
    assert tuple(nms_topk(a[:0], 4, -1.0)[1].shape) == (0, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nms_kernel_unaligned_map_takes_the_scalar_route(cuda, dtype):
    """A contiguous map that starts one element into its buffer cannot be
    read in 16-byte words."""
    gen = torch.Generator().manual_seed(3)
    buf = (torch.randn(2 * 128 * 128 + 1, generator=gen) * 3).to(cuda, dtype)
    m = buf[1:].view(2, 128, 128)
    assert m.is_contiguous() and m.data_ptr() % 16
    s, i = nms_topk(m, 128, -1.0)
    ps, pi = nms_topk_plain(m, 128, -1.0)
    assert torch.equal(s, ps) and torch.equal(i, pi)


def test_nms_kernel_all_survivors_at_full_grid(cuda):
    """A flat 128x128 map: all 16,384 cells survive and are sorted, in the
    default 48 KB of dynamic shared memory a CTA gets without asking."""
    m = torch.full((3, 128, 128), 0.5, device=cuda)
    s, i = nms_topk(m, 160, -1.0)
    ps, pi = nms_topk_plain(m, 160, -1.0)
    assert torch.equal(s, ps) and torch.equal(i, pi)
    assert i[0].tolist() == list(range(160))
    lib = peaks._lib()
    assert 0 < lib.abcnet_nms_topk_smem_bytes(128, 128, 160,
                                              peaks.CLUSTER) <= 48 * 1024
    assert lib.abcnet_nms_topk_cluster(128, 128, 160, peaks.CLUSTER) == \
        peaks.CLUSTER


def test_nms_kernel_single_band_shapes(cuda):
    """Shapes only one CTA can take: a single row of 16,384 cells with
    K = n (more than 48 KB of shared memory, asked for once), and maps with
    fewer rows than the cluster has CTAs."""
    gen = torch.Generator().manual_seed(4)
    for shape, k in (((1, 1, 16384), 16384), ((2, 3, 40), 120),
                     ((2, 5, 8), 40), ((1, 2, 8192), 300)):
        m = (torch.randn(*shape, generator=gen) * 3).to(cuda)
        s, i = nms_topk(m, k, -1.0)
        ps, pi = nms_topk_plain(m, k, -1.0)
        assert torch.equal(s, ps) and torch.equal(i, pi), shape


@pytest.fixture
def last_gpu(cuda):
    """The last visible GPU, with GPU 0 current: the wrappers must launch
    on their tensors' device, not the current one (on a one-GPU machine
    both are GPU 0)."""
    torch.cuda.set_device(0)
    return torch.device("cuda", torch.cuda.device_count() - 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_launch_on_their_tensors_device(last_gpu, dtype):
    bits = torch.from_numpy(packed_bits("random", 4)).to(last_gpu)
    got = unpack_bits(bits, dtype)
    assert got.device == last_gpu
    assert torch.equal(got, unpack_bits_plain(bits, dtype))
    rates = torch.full((4, 2), 0.1, device=last_gpu)
    assert torch.equal(unpack_noise(bits, rates, 5, dtype),
                       unpack_noise_plain(bits, rates, 5, dtype))
    maps = torch.randn(4, 128, 128, device=last_gpu,
                       generator=torch.Generator(device=last_gpu)
                       .manual_seed(0)).to(dtype)
    for got, want in zip(nms_topk_pair(maps, 128, maps, 160, -1.0),
                         (nms_topk_plain(maps, 128, -1.0),
                          nms_topk_plain(maps, 160, -1.0))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize(last_gpu)
    assert torch.cuda.current_device() == 0


def test_int8_conv_is_exact_on_the_card(cuda):
    """infer/quant.py's im2col + torch._int_mm against a float64 conv of
    the same int8 tensors: exact (K = 9 x 512 = 4608 terms)."""
    from abcnet_tpu_torch.infer.quant import conv_int8, convt_int8
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randint(-127, 128, (2, 16, 16, 512), generator=gen,
                      device=cuda, dtype=torch.int8)
    k = torch.randint(-127, 128, (3, 3, 512, 64), generator=gen,
                      device=cuda, dtype=torch.int8)
    x64 = x.double().permute(0, 3, 1, 2)
    want = torch.nn.functional.conv2d(x64, k.double().permute(3, 2, 0, 1),
                                      padding=1).permute(0, 2, 3, 1)
    assert torch.equal(conv_int8(x, k).double(), want)
    w = torch.flip(k.double(), (0, 1)).permute(2, 3, 0, 1)
    want = torch.nn.functional.conv_transpose2d(x64, w, stride=2)
    assert torch.equal(convt_int8(x, k).double(), want.permute(0, 2, 3, 1))


def _fixture_samples(n):
    import numpy as np

    from abcnet_tpu_torch.data.generate import Sample
    from torch_parity import FIXTURE, TRAIN_FIXTURE

    z, lab = np.load(FIXTURE), np.load(TRAIN_FIXTURE)
    return [Sample(z["images"][i], str(lab["atoms_string"][i]),
                   str(lab["bonds_string"][i]), str(lab["smiles"][i]))
            for i in range(n)]


def test_test_acc_unpacks_once_per_batch(cuda):
    """test-acc's route: one unpack kernel launch per batch, no NMS."""
    import random

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT, per_class_totals
    from abcnet_tpu_torch.data.pipeline import sample_to_example
    from abcnet_tpu_torch.models.weights import load_snapshot

    model, _ = load_snapshot(DEFAULT_SNAPSHOT, cuda, torch.bfloat16)
    rng = random.Random(0)
    examples = [sample_to_example(s, rng, train=False)
                for s in _fixture_samples(32)]
    before = (unpack_bits.launches, nms_topk.launches)
    counts = per_class_totals(model, examples, 16)
    torch.cuda.synchronize()
    assert (unpack_bits.launches - before[0],
            nms_topk.launches - before[1]) == (2, 0)
    assert sorted(counts) == ["atom_charge", "atom_type", "bond_type"]
    n_true = counts["atom_type"][3]
    assert n_true.dtype == torch.int64 and int(n_true.sum()) > 0


def test_final_eval_serving_launches_once_per_batch(cuda):
    """final_eval's serving route: one unpack and one NMS launch per batch
    of 16, both assemblers on the same peaks."""
    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.eval import final_eval
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models.weights import load_snapshot

    model, _ = load_snapshot(DEFAULT_SNAPSHOT, cuda, torch.bfloat16)
    run = make_infer_pipeline(model, cuda)
    samples = _fixture_samples(40)
    before = (unpack_bits.launches, nms_topk.launches)
    preds, preds_int = final_eval.serve_both(run, samples)
    torch.cuda.synchronize()
    assert (unpack_bits.launches - before[0],
            nms_topk.launches - before[1]) == (3, 3)
    assert len(preds) == len(preds_int) == 40
    assert sum(p is not None for p in preds) >= 38


@pytest.mark.parametrize("sparse", [True, False])
def test_bench_program_is_the_served_program(cuda, sparse):
    """The bench's serving program at batch 64 on the card: one unpack and
    one NMS launch, its clean-carry peak dict bit-equal to
    make_infer_pipeline's on the same images."""
    import numpy as np

    from abcnet_tpu_torch import bench
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.infer.decode import (make_infer_pipeline,
                                               sparse_heads)
    from abcnet_tpu_torch.models.weights import load_snapshot
    from torch_parity import SNAPSHOT

    model, _ = load_snapshot(SNAPSHOT, cuda, torch.bfloat16)
    images = bench.real_batch_images(9000, 64)
    bits = torch.from_numpy(pack_images(images, 0.6)).to(cuda)
    zero = torch.zeros((), dtype=torch.uint8, device=cuda)
    heads = sparse_heads(model, model.dtype) if sparse else None
    before = (unpack_bits.launches, nms_topk.launches)
    got, carry = bench.serve_step(model, heads, bits, zero)
    torch.cuda.synchronize()
    assert (unpack_bits.launches - before[0],
            nms_topk.launches - before[1]) == (1, 1)
    assert carry.device.type == "cuda" and carry.dtype == torch.uint8
    want = make_infer_pipeline(model, cuda, sparse=sparse)(images)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        v = v.cpu().numpy()
        assert v.dtype == want[k].dtype, k
        assert np.array_equal(v, want[k]), k


def test_decode_ceiling_peaks_kernel_equals_plain(cuda, monkeypatch):
    """The decode ceiling's route: extract_peaks on the perfect (plateau-
    rich, f32) logits of 4 samples on the card, one NMS launch a sample,
    every peak field bit-equal to the same decode with the plain NMS on
    the same device."""
    import random

    from abcnet_tpu_torch.data.generate import generate_sample
    from abcnet_tpu_torch.eval.decode_ceiling import perfect_logits
    from abcnet_tpu_torch.infer import decode

    samples, seed = [], 1000
    while len(samples) < 4:
        s = generate_sample(random.Random(seed),
                            mode=("rdkit", "indigo")[len(samples) % 2])
        seed += 1
        if s is not None:
            samples.append(s)
    for s in samples:
        logits = {k: v.to(cuda) for k, v in perfect_logits(s).items()}
        before = nms_topk.launches
        got = decode.extract_peaks(logits)
        torch.cuda.synchronize()
        assert nms_topk.launches == before + 1
        with monkeypatch.context() as m:
            m.setattr(decode, "nms_topk_pair", peaks.nms_topk_pair_plain)
            want = decode.extract_peaks(logits)
        assert nms_topk.launches == before + 1
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k


def test_degraded_sweep_launches_once_per_batch(cuda):
    """degraded_bench's route at both thresholds: one unpack and one NMS
    launch per batch of 16, each variant's first batch bit-equal to
    make_infer_pipeline at its threshold."""
    import numpy as np

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.eval import degraded_bench
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models.weights import load_snapshot

    model, _ = load_snapshot(DEFAULT_SNAPSHOT, cuda, torch.bfloat16)
    samples = _fixture_samples(32)
    variants = [v for v in degraded_bench.VARIANTS
                if v[0] in ("clean", "gray_scan_thr0.2")]
    before = (unpack_bits.launches, nms_topk.launches)
    rows = degraded_bench.sweep(model, samples, variants, verbose=False)
    torch.cuda.synchronize()
    assert (unpack_bits.launches - before[0],
            nms_topk.launches - before[1]) == (4, 4)
    for (name, fn, thr), r in zip(variants, rows):
        want = make_infer_pipeline(model, cuda, threshold=thr)(
            np.stack([fn(s.image) for s in samples[:16]]))
        assert r.name == name and sorted(want) == sorted(r.first_peaks)
        for k in want:
            assert np.array_equal(want[k], r.first_peaks[k]), (name, k)
        assert r.report.decode_rate >= 0.9


# ---------------------------------------------------------------------------
# bn_act (ops/bn_act.py, csrc/bn_act.cu): train-mode BatchNorm ->
# activation -> cast, forward and backward. The kernels and the plain
# version compute in f32 and round alike, but sum in another order, so
# these are tolerances (chip_smoke.py's BN_EPS comment gives the reasons):
# batch mean within 1e-5 of the channel's root mean square, variance 1e-5
# relative; bf16: y within one bf16 ulp (plus 1e-6 of the largest |y|,
# for values near 0), dx 1e-2 relative L2; f32: y within 1e-6 of the
# largest |y|, dx 1e-4 relative L2 where the two activation masks agree,
# the masks differing only where |pre| <= 1e-5 of the largest; dweight
# and dbias 1e-3 relative L2. With a conv bias (folded in, as the port's
# train step runs on the card), its gradient within chip_smoke.py's
# absolute bound BN_DCB_SUM_REL * sum|dx| per channel (the gradient is 0
# in exact arithmetic, so both sides hold rounding residue), and where it
# does not cancel (the backward's sums replaced by zeros, dy moved by +1)
# within u * |the float64 sum of dx| + 2^-13 * sum|dx|.
# ---------------------------------------------------------------------------

DCB_SUM_REL = {torch.bfloat16: 4 * 2 ** -8 + 2 ** -13,
               torch.float32: 4 * 2 ** -24 + 2 ** -13}
DCB_CHAIN_REL = 2 ** -13
UNIT_ROUNDOFF = {torch.bfloat16: 2 ** -8, torch.float32: 2 ** -24}

def _bn_inputs(shape, dtype, device, seed=0, fmt=torch.channels_last):
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    off = torch.rand(c, device=device, generator=gen) * 4 - 2
    spread = torch.rand(c, device=device, generator=gen) * 2.5 + 0.5
    x = torch.randn(shape, device=device, generator=gen)
    x = x.mul_(spread[:, None, None]).add_(off[:, None, None]).to(
        dtype, memory_format=fmt)
    dy = torch.randn(shape, device=device, generator=gen).to(
        dtype, memory_format=fmt)
    w = torch.rand(c, device=device, generator=gen) + 0.5
    b = torch.rand(c, device=device, generator=gen) - 0.5
    return x, dy, w, b


def _bn_run(fn, x, dy, w, b, act, cb=None):
    """(y, mean, var, dx, dw, db), and dcb where a conv bias is given."""
    leaves = [t.detach().requires_grad_(True)
              for t in (x, w, b, cb) if t is not None]
    y, mean, var = fn(*leaves[:3], 1e-5, act, None,
                      leaves[3] if cb is not None else None)
    return (y.detach(), mean, var,
            *torch.autograd.grad(y, leaves, dy))


def _rel_l2(got, want):
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def _y_within_bf16(got, want):
    want = want.float()
    diff = (got.float() - want).abs()
    floor = 1e-6 * float(want.abs().max())
    _, e = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), e - 8).masked_fill_(want == 0,
                                                                 0.0)
    return bool((diff <= ulp + floor).all())


def _abs_channel_sums(t):
    return t.double().abs().sum((0, 2, 3))


def _assert_bn_close(got, want, x, w, b, act, dparam_scale=1.0, cb=None):
    from abcnet_tpu_torch.ops.bn_act import bn_act, bn_act_plain
    y, mean, var, dx, dw, db = got[:6]
    yp, mp, vp, dxp, dwp, dbp = want[:6]
    assert float(((mean - mp).abs() / (mp.square() + vp).sqrt()).max()) \
        <= 1e-5
    assert float(((var - vp).abs() / vp).max()) <= 1e-5
    assert y.dtype == dx.dtype == x.dtype
    if x.dtype == torch.bfloat16:
        assert _y_within_bf16(y, yp)
        assert _rel_l2(dx, dxp) <= 1e-2
    else:
        assert float((y - yp).abs().max()) <= 1e-6 * float(yp.abs().max())
        with torch.no_grad():
            pre_k = bn_act(x, w, b, 1e-5, "none", None, cb)[0]
            pre_p = bn_act_plain(x, w, b, 1e-5, "none", None, cb)[0]
        agree = ((pre_k > 0) == (pre_p > 0)) | (act == "none")
        ties = pre_p.abs().masked_fill(agree, 0).max()
        assert float(ties) <= 1e-5 * float(pre_p.abs().max())
        err = torch.where(agree, dx - dxp, 0.0).norm()
        assert float(err / torch.where(agree, dxp, 0.0).norm()) <= 1e-4
    assert _rel_l2(dw, dwp * dparam_scale) <= 1e-3
    assert _rel_l2(db, dbp * dparam_scale) <= 1e-3
    if cb is not None:
        dcb, dcbp = got[6], want[6]
        assert dcb.dtype == dcbp.dtype == cb.dtype
        bound = DCB_SUM_REL[x.dtype] * _abs_channel_sums(dxp)
        assert bool(((dcb.double() - dcbp.double()).abs() <= bound).all())


LAYOUTS = {"channels_last": torch.channels_last,
           "nchw": torch.contiguous_format}


@pytest.mark.parametrize("shape", [(64, 512, 16, 16), (4, 16, 64, 64),
                                   (3, 5, 7, 9), (2, 40, 1, 24)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("fmt", sorted(LAYOUTS))
def test_bn_act_kernels_match_plain(cuda, shape, dtype, act, fmt):
    from abcnet_tpu_torch.ops import bn_act as ops
    x, dy, w, b = _bn_inputs(shape, dtype, cuda, fmt=LAYOUTS[fmt])
    before = [k.launches for k in ops.KERNELS]
    got = _bn_run(ops.bn_act, x, dy, w, b, act)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(ops.KERNELS, before)] == \
        [1, 1, 1, 1]
    # y and dx are channels_last, whatever x's layout (another is copied)
    assert all(t.is_contiguous(memory_format=torch.channels_last)
               for t in (got[0], got[3]))
    want = _bn_run(ops.bn_act_plain, x, dy, w, b, act)
    _assert_bn_close(got, want, x, w, b, act)


@pytest.mark.parametrize("shape", [(64, 512, 16, 16), (4, 16, 64, 64),
                                   (3, 5, 7, 9), (2, 40, 1, 24)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
def test_bn_act_kernels_with_conv_bias_match_plain(cuda, shape, dtype, act):
    from abcnet_tpu_torch.ops import bn_act as ops
    x, dy, w, b = _bn_inputs(shape, dtype, cuda, seed=1)
    cb = (torch.randn(shape[1], device=cuda) * 1.5).to(dtype)
    before = [k.launches for k in ops.KERNELS]
    got = _bn_run(ops.bn_act, x, dy, w, b, act, cb)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(ops.KERNELS, before)] == \
        [1, 1, 1, 1]
    want = _bn_run(ops.bn_act_plain, x, dy, w, b, act, cb)
    _assert_bn_close(got, want, x, w, b, act, cb=cb)
    # the statistics are those of x + cb, rounded to x's type
    xb = (x + cb[:, None, None]).double()
    mean = xb.mean((0, 2, 3))
    rms = (mean.square() + xb.var((0, 2, 3), correction=0)).sqrt()
    assert float(((got[1].double() - mean).abs() / rms).max()) <= 1e-5


@pytest.mark.parametrize("shape", [(16, 64, 64, 64), (8, 512, 16, 16)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_act_conv_bias_gradient_where_it_does_not_cancel(cuda, shape,
                                                            dtype):
    """Kernel (d) with the backward's two sums replaced by zeros and dy
    moved by +1: dx = gamma * invstd * g, whose channel sums do not
    cancel, against the float64 sum of the dx it wrote. On the second
    shape the split has few blocks (P), so that even in bf16 the bound
    is below 1/P of each channel's sum: a lost or doubled block partial
    would fail."""
    from abcnet_tpu_torch.ops import bn_act as ops
    c = shape[1]
    x, dy, w, b = _bn_inputs(shape, dtype, cuda, seed=2)
    dy = dy + 1
    cb = (torch.randn(c, device=cuda) * 1.5).to(dtype)
    st = ops.stats(x, 1e-5, cb)
    zeros = torch.zeros(2, c, device=cuda)
    dx, dcb = ops.grad_apply(x, dy, st, w, b, zeros, 1.0, "relu", cb)
    want = dx.double().sum((0, 2, 3))
    bound = UNIT_ROUNDOFF[dtype] * want.abs() + \
        DCB_CHAIN_REL * _abs_channel_sums(dx)
    assert dcb.dtype == dtype
    assert bool(((dcb.double() - want).abs() <= bound).all())
    assert float(want.abs().min()) > 0.0
    if c == 512:
        P, _ = ops._split(x, c, ops._vec(c, x, dy), ops.SUMS_KIND, "relu")
        assert float((bound / want.abs()).max()) < 1 / P
    # the partials merge in a fixed order: the same bits every launch
    dx2, dcb2 = ops.grad_apply(x, dy, st, w, b, zeros, 1.0, "relu", cb)
    assert torch.equal(dx, dx2) and torch.equal(dcb, dcb2)


def test_bn_act_on_streams_at_once_equals_alone(cuda):
    """Four bn_acts with a conv bias, forward and backward, each on its own
    stream and released together by one event behind a sleep kernel, so
    that their reductions run side by side: bit-equal to each run alone
    (every launch merges its own partials through its own tickets)."""
    from abcnet_tpu_torch.ops.bn_act import bn_act
    runs = []
    for i in range(4):
        dt = (torch.bfloat16, torch.float32)[i % 2]
        x, dy, w, b = _bn_inputs((4, 64, 32, 32), dt, cuda, seed=10 + i)
        cb = (torch.randn(64, device=cuda) * 1.5).to(dt)
        runs.append((x, dy, w, b, ("relu", "leaky_relu", "none")[i % 3],
                     cb))
    alone = [_bn_run(bn_act, *r) for r in runs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in runs]
    gate = torch.cuda.Stream()
    for _ in range(3):
        with torch.cuda.stream(gate):
            torch.cuda._sleep(50_000_000)
            opened = gate.record_event()
        together = []
        for st, r in zip(streams, runs):
            st.wait_stream(torch.cuda.current_stream())
            st.wait_event(opened)
            with torch.cuda.stream(st):
                together.append(_bn_run(bn_act, *r))
        torch.cuda.synchronize()
        for got, want in zip(together, alone):
            assert all(torch.equal(g, a) for g, a in zip(got, want))


def test_bn_act_offsets_past_int32(cuda):
    """129 x 1024 x 128² bf16 values, past 2^31 (the fused head bank at
    batch 128 is 2^31): x and dy repeat a 3-image base 43 times, so the
    statistics, y, dx and the per-image gradients equal the plain version
    on the base, and every image past the 2^31 offset is held to it."""
    from abcnet_tpu_torch.ops.bn_act import bn_act, bn_act_plain
    base = (3, 1024, 128, 128)
    xb, dyb, w, b = _bn_inputs(base, torch.bfloat16, cuda, seed=3)
    cl = torch.channels_last
    x = xb.repeat(43, 1, 1, 1).contiguous(memory_format=cl)
    dy = dyb.repeat(43, 1, 1, 1).contiguous(memory_format=cl)
    assert x.numel() > 2 ** 31
    y, mean, var, dx, dw, db = _bn_run(bn_act, x, dy, w, b, "relu")
    del x, dy
    want = _bn_run(bn_act_plain, xb, dyb, w, b, "relu")
    yv, dxv = y.unflatten(0, (43, 3)), dx.unflatten(0, (43, 3))
    for i in (0, 21, 42):
        _assert_bn_close((yv[i], mean, var, dxv[i], dw, db), want, xb, w, b,
                         "relu", dparam_scale=43.0)
    # every block of the repeat equals the first
    assert torch.equal(yv, yv[:1].expand_as(yv))
    assert torch.equal(dxv, dxv[:1].expand_as(dxv))


def test_bn_act_launches_on_its_tensors_device(last_gpu):
    from abcnet_tpu_torch.ops.bn_act import bn_act, bn_act_plain
    x, dy, w, b = _bn_inputs((4, 32, 32, 32), torch.bfloat16, last_gpu)
    got = _bn_run(bn_act, x, dy, w, b, "leaky_relu")
    assert all(t.device == last_gpu for t in got)
    _assert_bn_close(got, _bn_run(bn_act_plain, x, dy, w, b, "leaky_relu"),
                     x, w, b, "leaky_relu")
    torch.cuda.synchronize(last_gpu)
    assert torch.cuda.current_device() == 0


def test_bn_act_kernels_reject_what_they_do_not_take(cuda):
    from abcnet_tpu_torch.ops import bn_act as ops
    x = torch.zeros(2, 4, 8, 8, device=cuda)
    with pytest.raises(ValueError, match="channels_last"):
        ops.stats(x, 1e-5)
    x = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(TypeError):
        ops.stats(x.half(), 1e-5)
    st = ops.stats(x + 1, 1e-5)
    v = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="per-channel"):
        ops.apply(x, st, v.double(), v, "relu")
    for cb, exc in ((torch.ones(5, device=cuda), ValueError),
                    (torch.ones(4, device=cuda, dtype=torch.bfloat16),
                     TypeError),
                    (torch.ones(4), ValueError)):
        before = ops.stats.launches
        with pytest.raises(exc, match="conv_bias"):
            ops.stats(x, 1e-5, cb)
        assert ops.stats.launches == before


# ---------------------------------------------------------------------------
# bn_act_eval (ops/bn_act.py, csrc/bn_act.cu kernel (e)): eval-mode conv
# bias -> BatchNorm with the running statistics -> activation -> cast in
# one pass. The kernel pins the roundings of the chain it replaced (the
# bias add_, then cuDNN's inference kernel of the tensor's layout), so the
# tolerance is bit-equality with bn_act_eval_plain.
# ---------------------------------------------------------------------------

def _bn_eval_inputs(shape, dtype, device, seed=0, fmt=torch.channels_last):
    """(x, conv_bias, (running_mean, running_var, weight, bias))."""
    gen = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]

    def rand(*s):
        return torch.rand(*s, device=device, generator=gen)

    x = (torch.randn(shape, device=device, generator=gen) * 2 + 0.3).to(
        dtype, memory_format=fmt)
    conv_bias = ((rand(c) - 0.5) * 0.6).to(dtype)
    stats = ((rand(c) - 0.5) * 2, rand(c) * 3 + 1e-3, rand(c) + 0.5,
             rand(c) - 0.5)
    return x, conv_bias, stats


@pytest.mark.parametrize("shape", [(8, 16, 512, 512), (64, 512, 16, 16),
                                   (4, 1024, 128, 128), (3, 5, 7, 9),
                                   (2, 40, 1, 24)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("fmt", sorted(LAYOUTS))
@pytest.mark.parametrize("with_bias", [True, False])
def test_bn_act_eval_kernel_matches_plain(cuda, shape, dtype, act, fmt,
                                          with_bias):
    from abcnet_tpu_torch.ops import bn_act as ops
    x, cb, st = _bn_eval_inputs(shape, dtype, cuda, fmt=LAYOUTS[fmt])
    cb = cb if with_bias else None
    with torch.no_grad():
        before = ops.eval_apply.launches
        got = ops.bn_act_eval(x, cb, *st, 1e-5, act, dtype)
        torch.cuda.synchronize()
        assert ops.eval_apply.launches - before == 1
        want = ops.bn_act_eval_plain(x, cb, *st, 1e-5, act, dtype)
    assert got.dtype == dtype and got.stride() == x.stride()
    assert torch.equal(got, want)


def test_bn_act_eval_has_no_backward(cuda):
    """A call that autograd would track raises; under no_grad it runs."""
    from abcnet_tpu_torch.models.unet import UNet
    from abcnet_tpu_torch.ops.bn_act import bn_act_eval
    x, cb, st = _bn_eval_inputs((2, 16, 8, 8), torch.bfloat16, cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        bn_act_eval(x.requires_grad_(True), cb, *st, 1e-5, "relu",
                    torch.bfloat16)
    model = UNet(heads=(1, 1), dtype=torch.bfloat16).to(cuda).eval()
    images = torch.zeros(1, 64, 64, 1, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        model(images)
    with torch.no_grad():
        assert all(v.isfinite().all() for v in model(images).values())


def test_bn_act_eval_kernel_rejects_what_it_does_not_take(cuda):
    from abcnet_tpu_torch.ops.bn_act import bn_act_eval, eval_apply
    x, cb, st = _bn_eval_inputs((2, 16, 8, 8), torch.bfloat16, cuda)
    with torch.no_grad():
        with pytest.raises(ValueError, match="channels_last or contiguous"):
            eval_apply(x[:, :, :, ::2], cb, *st, 1e-5, "relu")
        with pytest.raises(TypeError):
            bn_act_eval(x, cb, *st, 1e-5, "relu", torch.float32)
        with pytest.raises(TypeError):
            eval_apply(x.half(), None, *st, 1e-5, "relu")
        with pytest.raises(ValueError, match="conv_bias"):
            eval_apply(x, cb.float(), *st, 1e-5, "relu")
        with pytest.raises(ValueError, match="per-channel"):
            eval_apply(x, cb, st[0].double(), *st[1:], 1e-5, "relu")


def _variant(name, dtype):
    from abcnet_tpu_torch.models.unet import UNet
    from abcnet_tpu_torch.models.unet_cbam import UNetCBAM
    from abcnet_tpu_torch.models.unet_s2d import UNetS2D
    return {"unet": lambda: UNet(dtype=dtype),
            "fused_bank": lambda: UNet(dtype=dtype, fused_head_bank=True),
            "s2d": lambda: UNetS2D(dtype=dtype),
            "cbam": lambda: UNetCBAM(dtype=dtype)}[name]()


# eval-mode BatchNorms a forward: dense (every head) and sparse (the two
# heatmap heads, the serving trunk)
EVAL_BN_LAUNCHES = {"unet": (34, 28), "fused_bank": (27, None),
                    "s2d": (28, 22), "cbam": (34, None)}
# BatchNorms a bf16 forward applies inside another kernel instead: the
# CBAM U-Net's four 5x5 stem sites (ops/stem_conv.py)
FUSED_BN_BF16 = {"cbam": 4}


@pytest.mark.parametrize("name", sorted(EVAL_BN_LAUNCHES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_eval_forward_through_the_kernel_is_the_chain(cuda, name, dtype,
                                                      monkeypatch):
    """Each model's eval forward through bn_act_eval's kernel is bit-equal
    to the same forward through bn_act_eval_plain (the chain it
    replaced), with one launch a BatchNorm."""
    from abcnet_tpu_torch.infer.decode import DENSE_HEADS_SPARSE_MODE
    from abcnet_tpu_torch.models import unet
    from abcnet_tpu_torch.ops import bn_act as ops
    torch.manual_seed(0)
    model = _variant(name, dtype).to(cuda).eval()
    for m in model.modules():
        if isinstance(m, unet.BatchNorm):
            m.running_mean.normal_(0.0, 0.3)
            m.running_var.uniform_(0.5, 2.0)
    gen = torch.Generator(device=cuda).manual_seed(1)
    images = (torch.rand(2, 128, 128, 1, device=cuda, generator=gen)
              < 0.1).to(dtype)
    dense_n, sparse_n = EVAL_BN_LAUNCHES[name]
    if dtype == torch.bfloat16:
        dense_n -= FUSED_BN_BF16.get(name, 0)

    def forwards():
        with torch.no_grad():
            out = [model(images)]
            if sparse_n is not None:
                heads, feats = model(images,
                                     dense_heads=DENSE_HEADS_SPARSE_MODE,
                                     return_features=True)
                out.append({**heads, "features": feats})
        return out

    before = ops.eval_apply.launches
    got = forwards()
    assert ops.eval_apply.launches - before == dense_n + (sparse_n or 0)
    monkeypatch.setattr(unet, "bn_act_eval", ops.bn_act_eval_plain)
    before = ops.eval_apply.launches
    want = forwards()
    assert ops.eval_apply.launches == before
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            assert torch.equal(g[k], w[k]), k


# ---------------------------------------------------------------------------
# conv_s8 (ops/conv_s8.py, csrc/conv_s8.cu): one int8 3x3 conv site,
# quantize -> s8 x s8 -> s32 -> dequantize, bias, activation, cast,
# against conv3x3_s8_plain (q8, im2col + torch._int_mm, the epilogue as
# separate ops) on the same inputs: bit-equal, compared as raw bits.
# ---------------------------------------------------------------------------

def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _s8_inputs(shape, co, device, dtype=torch.bfloat16, seed=0):
    """x (B, H, W, C_in) with about 2% of its values past the clamp, a
    random HWIO int8 kernel, the site's scale, coef and bias."""
    gen = torch.Generator(device=device).manual_seed(seed)
    ci = shape[-1]
    x = (torch.randn(shape, device=device, generator=gen) * 2).to(dtype)
    k = torch.randint(-127, 128, (3, 3, ci, co), device=device,
                      generator=gen, dtype=torch.int8)
    scale = 5.0 / 127.0 * (1 + seed / 7)
    sw = torch.rand(co, device=device, generator=gen) * 1e-3 + 1e-4
    bias = torch.randn(co, device=device, generator=gen) * 0.5
    return x, k, scale, scale * sw, bias


def _s8_check(x, k, scale, coef, bias, act, out_dtype):
    from abcnet_tpu_torch.ops.conv_s8 import (conv3x3_s8, conv3x3_s8_plain,
                                              pack_weights)
    before = conv3x3_s8.launches
    got = conv3x3_s8(x, pack_weights(k), scale, coef, bias, act, out_dtype)
    torch.cuda.synchronize()
    assert conv3x3_s8.launches == before + 1
    want = conv3x3_s8_plain(x, k, scale, coef, bias, act, out_dtype)
    assert got.dtype == out_dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("site", [s[0] for s in chip_smoke.CONV_S8_SITES])
def test_conv_s8_matches_plain_at_every_site(cuda, site):
    key, h, ci, co = next(s for s in chip_smoke.CONV_S8_SITES
                          if s[0] == site)
    act, out = chip_smoke.conv_s8_site(key)
    _s8_check(*_s8_inputs((2, h, h, ci), co, cuda), act,
              getattr(torch, out))


@pytest.mark.parametrize("shape,co", [((1, 13, 21, 1), 16),
                                      ((1, 7, 9, 48), 40),
                                      ((2, 17, 33, 40), 24),
                                      ((1, 5, 3, 16), 136),
                                      ((3, 31, 17, 8), 8),
                                      ((1, 1, 1, 32), 16),
                                      ((1, 9, 16, 3), 7)])
@pytest.mark.parametrize("act", ["relu", "leaky_relu", "none"])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
def test_conv_s8_matches_plain_at_odd_shapes(cuda, shape, co, act, out_dtype,
                                             in_dtype):
    """Odd H and W, batch 1, C_in = 1 and not a multiple of 32 (nor of 8:
    the scalar loads), C_out not a multiple of the tile (nor even: single
    stores), f32 input."""
    _s8_check(*_s8_inputs(shape, co, cuda, in_dtype, seed=shape[-1]), act,
              out_dtype)


def test_conv_s8_offsets_past_int32(cuda):
    """130 x 512² x 64 bf16 values, past 2^31 elements: the last images
    against the plain chain on them alone."""
    from abcnet_tpu_torch.ops.conv_s8 import (conv3x3_s8, conv3x3_s8_plain,
                                              pack_weights)
    x, k, scale, coef, bias = _s8_inputs((2, 512, 512, 64), 64, cuda)
    big = torch.zeros(130, 512, 512, 64, dtype=torch.bfloat16, device=cuda)
    big[-2:] = x
    assert big.numel() > 2 ** 31
    got = conv3x3_s8(big, pack_weights(k), scale, coef, bias)[-2:]
    del big
    want = conv3x3_s8_plain(x, k, scale, coef, bias)
    assert torch.equal(_bits(got), _bits(want))


def test_conv_s8_on_streams_at_once_equals_alone(cuda):
    from abcnet_tpu_torch.ops.conv_s8 import conv3x3_s8, pack_weights
    cases = [_s8_inputs((8, 64, 64, 64), 128, cuda, seed=s) for s in (1, 2)]
    args = [(x, pack_weights(k), s, c, b) for x, k, s, c, b in cases]
    alone = [conv3x3_s8(*a) for a in args]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in args]
    outs = []
    for st, a in zip(streams, args):
        st.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(st):
            outs.append(conv3x3_s8(*a))
    torch.cuda.synchronize()
    for got, want in zip(outs, alone):
        assert torch.equal(_bits(got), _bits(want))


def test_conv_s8_launches_on_its_tensors_device(last_gpu):
    x, k, scale, coef, bias = _s8_inputs((2, 32, 32, 16), 16, last_gpu)
    _s8_check(x, k, scale, coef, bias, "relu", torch.bfloat16)
    assert torch.cuda.current_device() == 0


def test_conv_s8_rejects_what_it_does_not_take(cuda):
    from abcnet_tpu_torch.ops.conv_s8 import conv3x3_s8, pack_weights
    x, k, scale, coef, bias = _s8_inputs((1, 8, 8, 16), 16, cuda)
    w = pack_weights(k)
    with pytest.raises(TypeError):
        conv3x3_s8(x.half(), w, scale, coef, bias)
    with pytest.raises(TypeError):
        conv3x3_s8(x.to(torch.int8), w, scale, coef, bias)
    with pytest.raises(ValueError):                 # not NHWC-contiguous
        conv3x3_s8(x.transpose(1, 2), w, scale, coef, bias)
    with pytest.raises(ValueError):                 # another C_in's layout
        conv3x3_s8(torch.cat([x, x, x], -1), w, scale, coef, bias)
    with pytest.raises(ValueError):                 # HWIO, not packed
        conv3x3_s8(x, k, scale, coef, bias)
    with pytest.raises(ValueError):
        conv3x3_s8(x, w, scale, coef.double(), bias)
    with pytest.raises(ValueError):
        conv3x3_s8(x, w, scale, coef, bias.cpu())
    with pytest.raises(TypeError):                  # a tensor divides exactly
        conv3x3_s8(x, w, torch.tensor(scale, device=cuda), coef, bias)
    with pytest.raises(ValueError):
        conv3x3_s8(x, w, scale, coef, bias, act="gelu")
    with pytest.raises(TypeError):
        conv3x3_s8(x, w, scale, coef, bias, out_dtype=torch.float16)


def test_int8_forward_goes_through_conv_s8(cuda, monkeypatch):
    """forward_quant on the card: 28 conv_s8 launches a batch, heads and
    features bit-equal to the same forward through conv3x3_s8_plain; the
    pipeline's int8 serving equals it through the plain chain."""
    import numpy as np

    from abcnet_tpu_torch.infer import quant
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models import UNet
    from abcnet_tpu_torch.ops import conv_s8

    torch.manual_seed(0)
    model = UNet(dtype=torch.bfloat16).to(cuda).eval()
    rng = np.random.default_rng(0)
    masks = (rng.random((4, 64, 64, 1)) < 0.1).astype(np.float32)
    bundle = quant.prepare_quant(model, masks)
    images = torch.from_numpy(masks).to(cuda)
    packed = quant.pack_bundle(bundle)
    assert sorted(packed) == sorted(k for k, _, _ in
                                    quant.conv_sites(bundle))
    before = conv_s8.conv3x3_s8.launches
    out, y = quant.forward_quant(bundle, images, packed=packed)
    torch.cuda.synchronize()
    assert conv_s8.conv3x3_s8.launches - before == 28
    rec = {}
    want_out, want_y = quant.forward_quant(bundle, images, rec=rec)
    assert conv_s8.conv3x3_s8.launches - before == 28
    assert torch.equal(_bits(y), _bits(want_y))
    for h in out:
        assert torch.equal(_bits(out[h]), _bits(want_out[h])), h

    u8 = (255 * (1 - masks[..., 0])).astype(np.uint8)
    got = make_infer_pipeline(model, cuda, quant=bundle)(u8)

    def plain(x, w, scale, coef, bias, act, out_dtype):
        return conv_s8.conv3x3_s8_plain(
            x, conv_s8.unpack_weights(w, x.shape[-1]), scale, coef, bias,
            act, out_dtype)

    monkeypatch.setattr(quant, "conv3x3_s8", plain)
    want = make_infer_pipeline(model, cuda, quant=bundle)(u8)
    assert sorted(got) == sorted(want)
    for k in got:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("scale", chip_smoke.CONV_S8_SCALES)
@pytest.mark.parametrize("in_dtype", [torch.bfloat16, torch.float32])
def test_conv_s8_quantizes_as_the_chain(cuda, scale, in_dtype):
    """Every finite bf16 value, and each f32 rounding boundary of the
    quantize with its neighbours, through an identity kernel: the output
    is q8 of the input, bit for bit, as the plain chain's is."""
    from abcnet_tpu_torch.ops.conv_s8 import (conv3x3_s8, conv3x3_s8_plain,
                                              pack_weights, q8)
    x = chip_smoke.conv_s8_sweep(torch, in_dtype, scale, cuda)
    k, coef, bias = chip_smoke.identity_s8(torch, cuda)
    got = conv3x3_s8(x, pack_weights(k), scale, coef, bias, "none",
                     torch.float32)
    assert torch.equal(got, q8(x, scale).float())
    want = conv3x3_s8_plain(x, k, scale, coef, bias, "none", torch.float32)
    assert torch.equal(_bits(got), _bits(want))
