"""The torch port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without
one: a CUDA kernel has no CPU mode, and the plain versions are held to
abcnet_tpu on the CPU by tests/test_torch_unpack.py,
tests/test_torch_noise.py and tests/test_torch_peaks.py. The file imports no JAX, so on the GPU
machine (which has none) it runs with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Tolerance: bit-equality, scores and every index slot included.
"""

import pytest
import torch

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
    peaks.null_launch(4, 128, 128, 160, device=last_gpu)
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
