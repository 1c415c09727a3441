#!/usr/bin/env python3
"""Smoke run of abcnet_tpu_torch on one GPU: serving (img2smiles) and
training (fit).

    python3 chip_smoke.py        # from the root of a checkout, one card

Drives the port's serving path — bit pack, unpack kernel, production U-Net
on the step-43100 snapshot, NMS/top-K kernel, sparse heads, packed
transport, host assembly, scoring — on the 64-molecule fixture
abcnet_tpu_torch/assets/smoke_step43100.npz, and prints one JSON line
per phase:

  1. environment: the card, its power limit and maximum SM clock, the
     kernel and assembler builds (all compilers started at once), ptxas's
     registers and spills, and the counts of the noise kernel's
     instructions by opcode (cuobjdump -sass);
  2. kernels against their plain PyTorch versions on the card, bit-equal
     (unpack on random and fixture bits; the noise kernel on twelve
     cases; NMS/top-K on random, plateau, threshold, edge, constant and
     below-threshold maps, on maps that try the seams between the
     kernel's bands of rows, K = 128 and 160, on an odd shape and on
     K = H*W, f32 and bf16, every cluster size, and both heatmaps in one
     launch against two plain calls);
  3. f32 serving (TF32 off): SMILES against the JAX package's f32 SMILES,
     gate >= 62/64;
  4. bf16 serving, the production setting, through the CLI's serving
     loop at batch 64, with the kernels' launch counts set to 0 just
     before and read just after: exact match against the truth next to
     the TPU's, gate port >= TPU - 3/64;
  5. times on the card: each kernel and its plain version at the serving
     shapes (median of 25 CUDA-event timings, each launched behind a
     sleep kernel so the host's launch overhead is not timed), the bound
     from the bytes each must move or the integer instructions it must
     run, an empty kernel in the NMS kernel's launch shape, the NMS
     kernel at every cluster size, a per-stage breakdown of one batch,
     the serving loop's img/s at batch 64 on fresh input, and a
     torch.profiler trace of the loop (device busy share, device time
     per operator);
  6. training (fixture abcnet_tpu_torch/assets/train_step43100.npz: the
     label strings of the same 64 molecules and the JAX package's f32
     eval losses on the first 16):
     - train_f32: `eval_step` in f32 (TF32 off) on the snapshot weights
       against the JAX losses, per term, relative 1e-3;
     - train_bf16: the production setting (bf16, batch 64, full width)
       from a seeded random init, TRAIN_STEPS steps through `fit` on the
       raw samples (geometric augment, collate, prefetch, noise kernel,
       targets, forward, losses, backward, Adam, the sampled metrics
       step, one evaluation), launch counts set to 0 before and read
       after; then the weights go through save_snapshot/load_snapshot
       and the serving pipeline decodes the fixture with them;
     - train_times: CUDA-event times per stage of one step, img/s of
       the fit loop, peak memory, a torch.profiler operator table;
  7. device_guard (run right after the build): every kernel wrapper on
     the last visible GPU while GPU 0 is current, bit-equal to its plain
     version (on a one-GPU machine it says so: "gpus": 1);
  8. ddp_train: two ranks of data-parallel training (NCCL on two GPUs, or
     both ranks on the one card over gloo, which is no speed figure), full
     width at 512²: the first f32 step at global batch 16 against one
     process at batch 16 on the same images (losses, gradients, running
     statistics), then bf16 at global batch 64 through `fit` for 10 steps
     with ms/step and peak memory per rank;
  9. mesh_serving: make_infer_pipeline over every visible GPU (four row
     blocks on a one-GPU machine), peak dicts bit-equal to the unsharded
     pipeline on each row block, SMILES against the whole batch, img/s;
     multiproc_serving: two ranks of a process group (NCCL on two GPUs,
     or both on the one card over gloo), each serving its 32 rows of the
     fixture batch through make_infer_pipeline(mesh=the rank's mesh) and
     assembling them in its own pool; rank 1 moves one statistic of its
     weights, which the pipeline's replication from rank 0 undoes; peak
     dicts bit-equal to the unsharded pipeline on each rank's row block,
     SMILES against the whole batch, launches per rank, img/s per rank;
 10. variants (bf16, 512², batch 64, seeded init): UNetS2D and UNetCBAM
     take 5 train steps each, S2D also serves; fused_head_bank and
     remat_blocks beside the plain UNet, first-step losses against it;
 11. quant_serving: prepare_quant on the snapshot, calibrated on 32
     fixture images, the 64 molecules served through the int8 backbone;
     exact match beside bf16, the int8 trunk's time against the bf16
     trunk's, int32 accumulators against a float64 conv on the card;
 12. generator (no GPU work): the port's molecule generator on the card's
     host makes the JAX package's data: the two held-out pools of
     final_eval (seeds 777001 rdkit, 777002 indigo, 256 each) against the
     512 truths of logs/final_eval_step43100.csv, the first 32 of each
     against the fixtures' label strings, SMILES and drawings (images
     reported as bit-equal counts and differing-pixel shares, with the
     Pillow and FreeType versions), every (mode, engine) stream and the
     corpus mode against assets/gen_digests.npz; samples per second;
     data.pipeline.generate_examples over a spawn pool of 4 against the
     serial concatenation of its chunks and the JAX package's list
     (assets/examples_digests.npz), its rate with the pool and on one
     thread;
 13. final_eval: the n=256 evaluation (eval/final_eval.py) in bf16 on the
     snapshot over those pools: heatmap metrics per lineage, exact /
     exact_canonical / dice / decode rate per lineage and overall with
     the sub-cell and the integer-cell assembler, row-by-row agreement
     with the TPU's smiles_pred; gates: overall exact >= the TPU's 0.8379
     - 0.02, decode rate >= 0.99, one unpack and one NMS launch per
     serving batch;
 14. cli_loop, through the port's main() in a temporary directory: gen ->
     train --synthetic -> img2smiles -> test-acc -> cal-acc on the
     results CSV and on a copy with InChI truths; img2smiles and test-acc
     --ckpt of the checkpoint directory train wrote, their peak dicts and
     counts against the module fit left in memory; then test-acc's counting
     in f32 (TF32 off) on fixture rows 0-15 against the JAX package's
     counts (assets/test_acc_step43100.npz);
 15. bench: `python -m abcnet_tpu_torch bench` (sparse, then its train
     steps at the default --train-batch, 64) and `bench --dense
     --skip-train` through the CLI's main(), each record printed, then
     the bench's train steps alone (paths `bench_sparse`, `bench_dense`,
     `bench_train`); gates: exit 0 and no error, the rates finite and
     > 0, implied TFLOP/s <= the H100's 989, one unpack and one NMS
     launch per call of the serving program and one noise launch per
     train step, the default snapshot's weights in the records, and the
     bench's program on the clean-carry batch of buffer 0 bit-equal to
     make_infer_pipeline on its images;
 16. the card line of nvidia-smi, then the kernels line, then the result.

Every new path is driven with the kernels' launch counts set to 0 just
before it and read just after (`launches_by_path` of the kernels line).
`--phases a,b` runs the environment phase and the named phases only (for
iterating on the card); with no arguments every phase runs but
`bench_probe`, which runs only when named: the JAX bench's train batch
128 in a process of its own, the reading that chose bench's
--train-batch default.

Exits non-zero on any failed phase, and without a result when there is
no CUDA device or no abcnet_tpu_torch package beside the script.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 64
REPS = 25
SLEEP_CYCLES = 4_000_000          # ~2 ms at H100 clocks, hides the launch
HBM_BYTES_PER_S = 3.35e12         # H100 SXM (data sheet)
F32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
# The noise kernel's arithmetic is 32-bit integer work. An SM of compute
# capability 9.0 executes 64 such instructions a clock (integer add, multiply
# and logic rows of the arithmetic-throughput table in NVIDIA's CUDA C++
# programming manual), half its 128 f32 lanes; the card has 132 SMs and its
# maximum SM clock is read from nvidia-smi (clocks.max.sm).
SMS = 132
INT32_LANES_PER_SM_CLOCK = 64
# The least integer instructions unpack + noise needs per packed byte (4
# Philox4x32-10 calls on counters that differ in their draw number only):
#   rounds 3-10 of the 4 calls, 2 wide multiplies + 2 three-input xors each
#   round 1: the multiply by the byte index, shared; 4 xors
#   round 2: 4 multiplies (the 4 draws still share one counter word), 7 xors
#   18 round-key additions, shared by the 4 calls
#   8 pixels x (2 compares + 2 logic operations)
#   8 pixels x 1 to select and pack the output value
NOISE_OPS_PER_BYTE = 8 * 4 * 4 + (1 + 4) + (4 + 7) + 18 + 8 * 4 + 8
TRAIN_STEPS = 30                  # steps of the train_bf16 phase
TRAIN_LOSS_FRACTION = 0.5         # gate: last total < this x first total
EVAL_REL_TOL = 1e-3               # train_f32: per loss term against JAX
# ddp_train, f32 step of two ranks against one process at batch 16 (TF32
# off, the snapshot weights, noise and dropout off). Only the order of the
# sums differs: losses and running statistics to 1e-4 relative; gradients
# by the relative L2 error of each leaf and of the whole tree. A train-mode
# BatchNorm backward amplifies the f32 order of the sums
# (tests/test_torch_parallel.py: up to 1.6e-2 on the CPU); on an H100 the
# first run measured 5.8e-4 and 2.6e-4, and the gates keep a tenfold margin.
DDP_LOSS_REL, DDP_STAT_REL = 1e-4, 1e-4
DDP_GRAD_LEAF, DDP_GRAD_TREE = 1e-2, 5e-3
DDP_BATCH_F32, DDP_BATCH_BF16, DDP_STEPS = 16, 64, 10
VARIANT_STEPS = 5
# fused head bank vs per-head, first-step losses in bf16: one 128->1024
# conv against eight 128->128 convs may round the bf16 logits differently.
FUSED_LOSS_REL = 2e-2
# int8 serving: the TPU's int8 run lost 1.2 points of exact match on 256
# rows (logs/quant_r5.log); 4 of 64 rows allow that and near-tie flips.
QUANT_EXACT_SLACK = 4 / 64
# mesh_serving: row blocks on a one-GPU machine, and the SMILES that may
# flip against the whole-batch run (near-tie NMS flips, as the f32 gate
# allows against JAX)
MESH_BLOCKS = 4
MESH_SMILES_SLACK = 2
# generator: molecules per held-out pool of final_eval; the largest share
# of an image's pixels that may differ from the fixture's drawing (engine A
# draws labels with Pillow and FreeType, whose builds may differ).
GEN_POOL_N = 256
PIXEL_SHARE_MAX = 0.01
# generate_examples: the size of the list timed over the default pool
EXAMPLES_BIG_N = 384
# final_eval: the TPU's overall bf16 exact match on the same 512 molecules
# (logs/final_eval_r5e.log) is the reference; the port may be 2 points
# below it (a different conv summation order flips near-tie peaks).
FINAL_EVAL_TPU_EXACT = 0.8379
FINAL_EVAL_SLACK = 0.02
FINAL_EVAL_DECODE_MIN = 0.99
# cli_loop: test-acc's f32 counts on fixture rows 0-15 against the JAX
# package's, each within max(2, 1%) (near-tie peaks of f32 logits).
TESTACC_ABS, TESTACC_REL = 2, 0.01
# multiproc_serving: two ranks, each serving its rows of the fixture batch
# of 64 and assembling them in its own pool of MULTIPROC_POOL processes;
# rank 1 moves one running statistic of its weights before its pipeline
# replicates rank 0's. SMILES may flip against the whole-batch run as in
# mesh_serving (MESH_SMILES_SLACK).
MULTIPROC_RANKS = 2
MULTIPROC_POOL = 2
MOVED_STAT = "down4.double_conv.bn1.running_mean"
# bench: the port's --train-batch default, and the JAX bench's
# (bench.py:62), which `--phases bench_probe` probes on the card in a
# process of its own (it ran out of memory, so the port's default is
# BATCH).
BENCH_TRAIN_BATCH = BATCH
BENCH_JAX_TRAIN_BATCH = 128


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def sass_opcodes(path, kernel_substring):
    """{opcode: count} over the SASS of the kernels in the library `path`
    whose mangled name holds `kernel_substring` (cuobjdump -sass), the
    opcode cut at its first dot but for the wide and high multiplies."""
    import collections
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in out.splitlines():
        if "Function :" in line:
            inside = kernel_substring in line
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d+\s+)?([A-Z0-9_.]+)",
                     line)
        if inside and m:
            op = m.group(1)
            keep = [t for t in op.split(".")[1:] if t in ("WIDE", "HI")]
            counts[".".join([op.split(".")[0], *keep])] += 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, reps=REPS):
    """Median device time of fn() over `reps` runs. Each run is queued
    behind a sleep kernel, so the events bracket only the device work."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in ev)
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_environment(torch):
    from abcnet_tpu_torch.infer.native import load_native
    from abcnet_tpu_torch.utils import build

    t0 = time.time()
    paths = build.build()
    build_s = time.time() - t0
    ptxas = {}
    for name in build.KERNELS:
        with open(paths[name] + ".log") as f:
            ptxas[name] = [ln.strip() for ln in f
                           if "registers" in ln or "spill" in ln]
    # The bf16 instance of the noise kernel: Lb1 is the mangled <true>.
    sass = sass_opcodes(paths["noise"], "unpack_noise_kernelILb1")
    emit("environment", ok=True, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi_line(), max_sm_clock_mhz=max_sm_clock_hz() / 1e6,
         torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
         ptxas=ptxas, noise_bf16_sass_opcodes=sass,
         assembler="native" if load_native() is not None else "numpy")


def _peak_cases(torch, g=128, b=BATCH):
    gen = torch.Generator().manual_seed(0)
    cases = [("random_x3", torch.randn(b, g, g, generator=gen) * 3, -1.0)]
    plateau = torch.full((b, g, g), -5.0)
    edges = torch.zeros((b, g, g))
    for i in range(b):
        r, c = (4 * i) % (g - 2), (7 * i + 3) % (g - 2)
        plateau[i, r:r + 2, c:c + 2] = 2.0             # all four survive
        plateau[i, (r + 60) % g, (c + 60) % g] = -1.0  # at threshold: drops
        plateau[i, (r + 30) % g, (c + 90) % g] = 7.0   # isolated peak
        edges[i, 0, 0], edges[i, 0, g - 1] = 3.0, 4.0
        edges[i, g - 1, g - 1], edges[i, g - 1, 0] = 5.0, 0.5
        edges[i, i % g, g - 1] = 6.0                   # an edge peak
    cases += [("plateau_threshold", plateau, -1.0), ("edges", edges, 0.5),
              ("constant", torch.full((b, g, g), 0.25), -1.0),
              ("below_threshold", torch.full((b, g, g), -2.0), -1.0)]

    # Maps that try the seams between the kernel's bands of rows (32 rows
    # each at cluster size 4, 16 at 8).
    seams = torch.full((b, g, g), -5.0)
    dense = torch.full((b, g, g), -5.0)
    ties = torch.full((b, g, g), -5.0)
    late = torch.full((b, g, g), -5.0)
    dense[:, 0:32:2, 0:g:2] = torch.rand(b, 16, g // 2, generator=gen) * 4
    dense[:, 40, 40], dense[:, 70, 5], dense[:, g - 1, g - 1] = 9.0, 8.0, 7.0
    late[:, 100:g:3, 1:g:9] = torch.rand(b, 10, 15, generator=gen) * 3
    late[:, 0, 0] = -1.0                               # at threshold: drops
    for i in range(b):
        for n, seam in enumerate((32, 64, 96)):
            c = 10 + 30 * n + i % 20
            seams[i, seam - 1:seam + 1, c:c + 2] = 2.0 + n     # plateau
            seams[i, seam - 1, c + 8] = seams[i, seam + 1, c + 8] = 1.5
            seams[i, seam - 1, 0] = seams[i, seam, g - 1] = 4.0 + n
            seams[i, seam, 3] = 3.0                    # on a seam row
            seams[i, seam - 1, 100], seams[i, seam, 101] = 0.5, 0.75
        for r, c in ((120, 3), (5, 100), (64, 64), (33, 0), (31, g - 1),
                     (96, 7), (5, 2), (70, 90)):
            ties[i, r, (c + i) % g] = 1.25             # one score, 4 bands
        ties[i, 50, 50] = 6.0
    cases += [("band_seams", seams, -1.0), ("dense_band", dense, -1.0),
              ("ties_across_bands", ties, -1.0), ("late_band_only", late, -1.0)]
    return cases


def _small_peak_cases(torch, b=BATCH):
    """Shapes off the serving path, each with its own K: a width that takes
    the kernel's scalar route, and K = H*W on a map smaller than 2K cells,
    where the exhausted slots come from every band's bitmask."""
    gen = torch.Generator().manual_seed(1)
    return [("odd_shape", torch.randn(b, 20, 28, generator=gen) * 3, -1.0, 24),
            ("k_equals_n", torch.randn(b, 8, 8, generator=gen) * 3, -1.0, 64)]


def check_nms(torch, maps, k, thr, cluster=None, got=None):
    """Kernel vs plain version on one batch of maps. Returns (max abs
    score difference over finite slots, slots compared, whether every
    index slot is equal, the exhausted ones too). Raises if a score or an
    index of a finite slot differs. `got` is a result to hold against the
    plain version in place of a single-map launch."""
    from abcnet_tpu_torch.ops.peaks import CLUSTER, nms_topk, nms_topk_plain
    s, i = got if got is not None else nms_topk(maps, k, thr,
                                                cluster or CLUSTER)
    ps, pi = nms_topk_plain(maps, k, thr)
    finite = torch.isfinite(ps)
    if not torch.equal(torch.isfinite(s), finite):
        raise AssertionError("nms_topk: finite slots differ")
    if not torch.equal(s[finite], ps[finite]) or \
            not torch.equal(i[finite], pi[finite]):
        raise AssertionError("nms_topk: finite slots differ in score or "
                             "index")
    err = float((s[finite] - ps[finite]).abs().max()) if finite.any() \
        else 0.0
    return err, int(finite.sum()), bool(torch.equal(i, pi))


def check_nms_pair(torch, a_map, b_map, thr=-1.0):
    """Both maps through one launch (K = 128 and 160, as the decode calls
    it) against two plain calls. Returns (max abs error, every index slot
    equal); raises on a difference in a finite slot or a launch count
    other than one."""
    from abcnet_tpu_torch.ops.peaks import nms_topk, nms_topk_pair
    before = nms_topk.launches
    got_a, got_b = nms_topk_pair(a_map, 128, b_map, 160, thr)
    if nms_topk.launches != before + 1:
        raise AssertionError("nms_topk_pair: not one launch")
    err_a, _, idx_a = check_nms(torch, a_map, 128, thr, got=got_a)
    err_b, _, idx_b = check_nms(torch, b_map, 160, thr, got=got_b)
    return max(err_a, err_b), idx_a and idx_b


def check_noise(torch, bit_sets, dev):
    """The noise kernel against its plain version, bit-equal, and against
    what it must do: rates 0 are the pure unpack; the realized salt and
    pepper fractions of each image lie within 6 binomial standard
    deviations (+ 1e-6) of its rates; the same (rates, seed) gives the
    same mask; images of one batch get different noise. Returns (cases,
    max abs difference from the plain version)."""
    from abcnet_tpu_torch.data.pipeline import draw_noise_rates
    from abcnet_tpu_torch.ops.noise import unpack_noise, unpack_noise_plain
    from abcnet_tpu_torch.ops.unpack import unpack_bits

    gen = torch.Generator(device=dev).manual_seed(0)
    cases, err = [], 0.0
    for name, bits_np in bit_sets.items():
        bits = torch.from_numpy(bits_np).to(dev)
        b = bits.shape[0]
        ink = unpack_bits(bits, torch.float32) > 0
        rates = draw_noise_rates(b, 0.2, dev, gen)
        for dt in (torch.bfloat16, torch.float32):
            for seed in (0, 43100, 2 ** 63 - 2):
                got = unpack_noise(bits, rates, seed, dt)
                want = unpack_noise_plain(bits, rates, seed, dt)
                err = max(err, float((got.float() - want.float()).abs().max()))
                if not torch.equal(got, want):
                    raise AssertionError(f"unpack_noise {name} {dt} seed "
                                         f"{seed}: differs from plain")
                if not torch.equal(got, unpack_noise(bits, rates, seed, dt)):
                    raise AssertionError("unpack_noise: not repeatable")
                cases.append(f"{name}/{str(dt)[6:]}/seed={seed}")
            zero = unpack_noise(bits, torch.zeros_like(rates), 7, dt)
            if not torch.equal(zero, unpack_bits(bits, dt)):
                raise AssertionError(f"unpack_noise {name} {dt}: rates 0 "
                                     "differ from unpack_bits")
        # Realized rates. Pepper alone (salt 0) erases ink at rate p; salt
        # alone (pepper 0) inks white pixels at rate s.
        zeros = torch.zeros(b, device=dev)
        pep = unpack_noise(bits, torch.stack([zeros, rates[:, 1]], 1), 11,
                           torch.float32) > 0
        salt = unpack_noise(bits, torch.stack([rates[:, 0], zeros], 1), 11,
                            torch.float32) > 0
        n_ink = ink.sum((1, 2)).double()
        n_white = (~ink).sum((1, 2)).double()
        worst = 0.0
        for want, n, hits in (
                (rates[:, 1].double(), n_ink, (ink & ~pep).sum((1, 2))),
                (rates[:, 0].double(), n_white, (salt & ~ink).sum((1, 2)))):
            n = n.clamp(min=1)
            tol = 6 * torch.sqrt(want * (1 - want) / n) + 1e-6
            dev_sigma = ((hits.double() / n - want).abs() / tol).max()
            worst = max(worst, float(dev_sigma))
        if worst > 1.0:
            raise AssertionError(f"unpack_noise {name}: realized rates off "
                                 f"by {worst:.2f} x the 6-sigma tolerance")
        full = unpack_noise(bits[:1].expand(2, -1, -1).contiguous(),
                            rates[:1].expand(2, -1).contiguous(), 3,
                            torch.float32)
        if torch.equal(full[0], full[1]):
            raise AssertionError("unpack_noise: two images of a batch got "
                                 "the same noise")
        cases.append(f"{name}/rates within {worst:.2f} of the 6-sigma "
                     "tolerance")
    return cases, err


def phase_kernels(torch, fixture):
    import numpy as np

    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.ops.unpack import unpack_bits, unpack_bits_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    bit_sets = {
        "random": rng.integers(0, 256, (BATCH, 512, 64), dtype=np.uint8),
        "fixture": pack_images(fixture["images"]),
    }
    unpack_err, unpack_cases = 0.0, []
    for name, bits in bit_sets.items():
        t = torch.from_numpy(bits).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            got, want = unpack_bits(t, dt), unpack_bits_plain(t, dt)
            if not torch.equal(got, want):
                raise AssertionError(f"unpack_bits {name} {dt}: differs")
            unpack_err = max(unpack_err,
                             float((got.float() - want.float()).abs().max()))
            unpack_cases.append(f"{name}/{str(dt)[6:]}")

    noise_cases, noise_err = check_noise(torch, bit_sets, dev)

    nms_err, nms_cases = 0.0, []
    big = _peak_cases(torch)
    cases = [(name, maps, thr, k) for name, maps, thr in big
             for k in (128, 160)] + _small_peak_cases(torch)
    for name, maps, thr, k in cases:
        for dt in (torch.float32, torch.bfloat16):
            m = maps.to(dev, dt)
            err, n_finite, all_idx = check_nms(torch, m, k, thr)
            # the same slots whatever number of CTAs shares a map
            others = all(check_nms(torch, m, k, thr, c)[2] for c in (1, 2, 8))
            nms_err = max(nms_err, err)
            nms_cases.append({"case": name, "dtype": str(dt)[6:],
                              "k": k, "finite_slots": n_finite,
                              "all_indices_equal": all_idx,
                              "cluster_1_2_8_equal": others})
    # Both heatmaps in one launch: every case beside the next one.
    for (name, a_map, thr), (other, b_map, _) in zip(big, big[1:] + big[:1]):
        for dt in (torch.float32, torch.bfloat16):
            err, all_idx = check_nms_pair(torch, a_map.to(dev, dt),
                                          b_map.to(dev, dt), thr)
            nms_err = max(nms_err, err)
            nms_cases.append({"case": f"pair:{name}+{other}",
                              "dtype": str(dt)[6:], "k": [128, 160],
                              "all_indices_equal": all_idx})
    torch.cuda.synchronize()
    if not all(c["all_indices_equal"] and c.get("cluster_1_2_8_equal", True)
               for c in nms_cases):
        raise AssertionError("nms_topk: an exhausted slot's index differs "
                             "from the plain version")
    emit("kernels_vs_plain", ok=True, unpack_cases=unpack_cases,
         unpack_max_abs_err=unpack_err, noise_cases=noise_cases,
         noise_max_abs_err=noise_err, nms_cases=nms_cases,
         nms_max_abs_err=nms_err)
    return {"unpack_bits": unpack_err, "unpack_noise": noise_err,
            "nms_topk": nms_err}


def serve(torch, fixture, dtype, images=None):
    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT, img2smiles_loop
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models.weights import load_snapshot

    model, step = load_snapshot(DEFAULT_SNAPSHOT, "cuda", dtype)
    run = make_infer_pipeline(model, "cuda")
    imgs = fixture["images"] if images is None else images
    preds = img2smiles_loop(run, list(imgs), BATCH, log_every=0)
    return model, run, [p or "" for p in preds]


def phase_f32(torch, fixture):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, preds = serve(torch, fixture, torch.float32)
    ref = fixture["jax_f32"].tolist()
    agree = sum(p == r for p, r in zip(preds, ref))
    mismatched = [{"row": i, "port": p, "jax_f32": r}
                  for i, (p, r) in enumerate(zip(preds, ref)) if p != r]
    ok = agree >= 62
    emit("serving_f32", ok=ok, agree_with_jax_f32=agree, n=len(ref),
         gate=">= 62", mismatched=mismatched)
    if not ok:
        raise AssertionError("f32 serving disagrees with the JAX SMILES")


def phase_bf16(torch, fixture):
    from abcnet_tpu_torch.eval.scoring import score_pairs
    from abcnet_tpu_torch.ops.peaks import nms_topk
    from abcnet_tpu_torch.ops.unpack import unpack_bits

    torch.cuda.reset_peak_memory_stats()
    unpack_bits.launches = 0
    nms_topk.launches = 0
    t0 = time.time()
    model, run, preds = serve(torch, fixture, torch.bfloat16)
    wall = time.time() - t0
    launches = {"unpack_bits": unpack_bits.launches,
                "nms_topk": nms_topk.launches}
    truth = fixture["truth"].tolist()
    tpu = fixture["tpu_bf16"].tolist()
    port_rep = score_pairs(truth, [p or None for p in preds])
    tpu_rep = score_pairs(truth, [p or None for p in tpu])
    agree = sum(p == t for p, t in zip(preds, tpu))
    n_batches = -(-len(truth) // BATCH)
    ok = (port_rep.exact_match >= tpu_rep.exact_match - 3 / 64
          and launches == {"unpack_bits": n_batches, "nms_topk": n_batches})
    emit("serving_bf16", ok=ok, launches=launches,
         agree_with_tpu_bf16=agree, n=len(truth),
         port_exact=port_rep.exact_match, tpu_exact=tpu_rep.exact_match,
         gate="port_exact >= tpu_exact - 3/64; one unpack and one NMS "
              "launch per batch", port=str(port_rep),
         tpu=str(tpu_rep), wall_s_incl_load=wall,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         mismatched_vs_tpu=[{"row": i, "port": p, "tpu": t}
                            for i, (p, t) in enumerate(zip(preds, tpu))
                            if p != t])
    if not ok:
        raise AssertionError("bf16 serving below the gate")
    return model, run, launches, preds


def stage_breakdown(torch, model, images_u8):
    """Device time per stage of one serving batch (CUDA events between
    the stages of make_infer_pipeline's device function, launched as the
    pipeline launches them), and host time of the pack and assembly."""
    import numpy as np

    from abcnet_tpu_torch.data.pipeline import device_unpack_bits, \
        pack_images
    from abcnet_tpu_torch.infer import decode
    from abcnet_tpu_torch.infer.assemble import assemble_batch

    dt = model.dtype
    heads = decode.sparse_heads(model, dt)
    cfg = decode.DecodeConfig()
    t0 = time.perf_counter()
    bits_np = pack_images(images_u8)
    host_pack_ms = (time.perf_counter() - t0) * 1e3
    names = ("h2d", "unpack", "trunk_and_heatmaps", "peaks_and_sparse_heads",
             "pack_and_d2h")
    res = {n: [] for n in names}
    res["assembly_host"] = []
    with torch.no_grad():
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            torch.cuda.synchronize()
            ev[0].record()
            bits = torch.from_numpy(bits_np).pin_memory().cuda(
                non_blocking=True)
            ev[1].record()
            images = device_unpack_bits(bits, dtype=dt)
            ev[2].record()
            heatmaps, feats = model(images,
                                    dense_heads=decode.DENSE_HEADS_SPARSE_MODE,
                                    return_features=True)
            ev[3].record()
            peaks = decode.extract_peaks_sparse(heatmaps, feats, heads, cfg,
                                                dt)
            ev[4].record()
            ib, fb = decode.pack_peaks(peaks)
            host = decode.unpack_peaks_host(ib.cpu().numpy(),
                                            fb.cpu().numpy(),
                                            decode.peaks_spec(peaks))
            ev[5].record()
            torch.cuda.synchronize()
            for j, n in enumerate(names):
                res[n].append(ev[j].elapsed_time(ev[j + 1]))
            t0 = time.perf_counter()
            assemble_batch(host)
            res["assembly_host"].append((time.perf_counter() - t0) * 1e3)
    out = {n: float(np.median(v)) for n, v in res.items()}
    out["pack_host"] = host_pack_ms
    return out, heatmaps


def phase_times(torch, fixture, model, run, launches, errs):
    import numpy as np

    from abcnet_tpu_torch.__main__ import img2smiles_loop
    from abcnet_tpu_torch.data.pipeline import draw_noise_rates, pack_images
    from abcnet_tpu_torch.ops.noise import int32_probe, unpack_noise, \
        unpack_noise_plain
    from abcnet_tpu_torch.ops.peaks import CLUSTER, nms_topk, \
        nms_topk_pair, nms_topk_pair_plain, null_launch
    from abcnet_tpu_torch.ops.unpack import unpack_bits, unpack_bits_plain

    images = fixture["images"]
    stages, heatmaps = stage_breakdown(torch, model, images)
    emit("stages_ms", ok=True, batch=BATCH, **stages)

    # The serving shapes: (64, 512, 64) packed bits -> bf16 (64, 512, 512);
    # the two (64, 128, 128) bf16 heatmaps, K = 128 (atoms), 160 (bonds).
    dt = model.dtype
    bits = torch.from_numpy(pack_images(images)).cuda()
    a_map = heatmaps["atom_target"][..., 0].contiguous()
    b_map = heatmaps["bond_target"][..., 0].contiguous()
    for m, k in ((a_map, 128), (b_map, 160)):      # real maps, real data
        err, _, all_idx = check_nms(torch, m, k, -1.0)
        errs["nms_topk"] = max(errs["nms_topk"], err)
        if not all_idx:
            raise AssertionError("nms_topk on the real heatmaps: an index "
                                 "slot differs from the plain version")
    err, all_idx = check_nms_pair(torch, a_map, b_map)
    errs["nms_topk"] = max(errs["nms_topk"], err)
    if not all_idx:
        raise AssertionError("nms_topk_pair on the real heatmaps: an index "
                             "slot differs from the plain version")

    def pair(cluster=CLUSTER):
        return lambda: nms_topk_pair(a_map, 128, b_map, 160, -1.0, cluster)

    el = 2 if dt == torch.bfloat16 else 4
    unpack_bytes = bits.numel() + bits.numel() * 8 * el
    nms_bytes = (a_map.numel() + b_map.numel()) * el + BATCH * (128 + 160) * 8
    nms_ops = (a_map.numel() + b_map.numel()) * 9     # 3x3 compares
    # The training shapes: the same packed batch, one rate pair per image
    # (amount 0.2, as fit draws them), the seed in device memory.
    rates = draw_noise_rates(BATCH, 0.2, bits.device,
                             torch.Generator(device="cuda").manual_seed(1))
    seed = torch.tensor([43100], dtype=torch.int64, device="cuda")
    noise_bytes = unpack_bytes + rates.numel() * 4 + 8
    noise_ops = bits.numel() * NOISE_OPS_PER_BYTE
    int32_ops_per_s = SMS * INT32_LANES_PER_SM_CLOCK * max_sm_clock_hz()
    rows = [
        ("unpack_bits", "abcnet_tpu_torch/csrc/unpack.cu",
         "abcnet_tpu/ops/pallas_input.py:59",
         lambda: unpack_bits(bits, dt), lambda: unpack_bits_plain(bits, dt),
         unpack_bytes, bits.numel() * 8, "f32",
         f"({BATCH},512,64) u8 -> ({BATCH},512,512) {str(dt)[6:]}"),
        ("unpack_noise", "abcnet_tpu_torch/csrc/noise.cu",
         "abcnet_tpu/ops/pallas_input.py:63",
         lambda: unpack_noise(bits, rates, seed, dt),
         lambda: unpack_noise_plain(bits, rates, seed, dt),
         noise_bytes, noise_ops, "int32",
         f"({BATCH},512,64) u8 + ({BATCH},2) f32 rates -> ({BATCH},512,512) "
         f"{str(dt)[6:]}; launches counted over the train_bf16 phase"),
        ("nms_topk", "abcnet_tpu_torch/csrc/nms_topk.cu",
         "abcnet_tpu/ops/pallas_peaks.py:78",
         pair(),
         lambda: nms_topk_pair_plain(a_map, 128, b_map, 160, -1.0),
         nms_bytes, nms_ops, "f32",
         f"1 launch per batch for both maps: 2 x ({BATCH},128,128) "
         f"{str(dt)[6:]}, K=128 and K=160, cluster of {CLUSTER} CTAs a map"),
    ]
    kernels = []
    for name, src, repl, kern, plain, nbytes, nops, ops_type, shape in rows:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / (int32_ops_per_s if ops_type == "int32"
                        else F32_OPS_PER_S) * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": device_ms(torch, kern), "plain_ms": device_ms(torch, plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "operations_type": ops_type, "shape": shape})

    dense = (torch.randn(BATCH, 128, 128, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(2)) * 3).to(dt)
    # Beside the NMS row: the two single-map launches it replaced, an empty
    # kernel in its launch shape, and the pair at every cluster size.
    nms_extra = {
        "two_launch_ms": device_ms(torch, lambda: (
            nms_topk(a_map, 128, -1.0), nms_topk(b_map, 160, -1.0))),
        "null_launch_ms": device_ms(torch, lambda: null_launch(
            BATCH, 128, 128, 160, maps=2)),
        "by_cluster_ms": {str(c): device_ms(torch, pair(c))
                          for c in (1, 2, 4, 8)},
        # maps with far more than K survivors in every band (random logits,
        # what an untrained model gives): the sorting route
        "dense_maps_ms": device_ms(torch, lambda: nms_topk_pair(
            dense, 128, dense, 160, -1.0)),
    }
    # Beside the noise row: what the card executes of a Philox round's
    # instruction mix, against the table rate the bound is made from.
    probe_out = torch.empty(SMS * 16 * 256, dtype=torch.int32, device="cuda")
    probe_ops = int32_probe(probe_out, 2048) * probe_out.numel()
    probe_ms = device_ms(torch, lambda: int32_probe(probe_out, 2048))
    noise_extra = {
        "int32_table_ops_per_s": int32_ops_per_s,
        "int32_probe_ops_per_s": probe_ops / (probe_ms * 1e-3),
        "ops_per_byte": NOISE_OPS_PER_BYTE,
        "bytes_bound_ms": noise_bytes / HBM_BYTES_PER_S * 1e3,
    }
    emit("kernel_times", ok=True, kernels=[
        {**k, "bound_by": k["bound_by"] if k["bound_by"] == "bytes"
         else f"{k['operations_type']} operations",
         **(nms_extra if k["name"] == "nms_topk" else {}),
         **(noise_extra if k["name"] == "unpack_noise" else {})}
        for k in kernels])

    # Serving loop at batch 64 on fresh input: eight distinct batches (the
    # fixture shifted by a few pixels), a host fetch of every batch's
    # peaks, host assembly overlapped as in the CLI.
    fresh = [np.roll(images, s, axis=2) for s in range(1, 9)]
    flat = [im for batch in fresh for im in batch]
    img2smiles_loop(run, flat[:BATCH], BATCH, log_every=0)        # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img2smiles_loop(run, flat, BATCH, log_every=0)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for batch in fresh:
        run(batch)                      # dispatch + fetch, no assembly
    pipe_s = time.perf_counter() - t0
    emit("serving_throughput", ok=True, batch=BATCH, images=len(flat),
         loop_img_per_s=len(flat) / loop_s,
         pipeline_img_per_s=len(flat) / pipe_s,
         note="loop = CLI serving loop incl. host assembly; pipeline = "
              "dispatch + fetch per batch, no assembly")
    trace_serving(torch, run, flat)
    return kernels


def trace_summary(prof, n):
    """(device busy microseconds = the union of the kernel spans, device
    milliseconds per operator and per one of `n` batches or steps, largest
    first) of a torch.profiler trace."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, None
    for s, e in spans:                       # length of the union
        if end is None or s > end:
            busy_us += e - s
            end = e
        elif e > end:
            busy_us += e - end
            end = e
    ops = sorted(((a.key, a.self_device_time_total / 1e3 / n)
                  for a in prof.key_averages()
                  if a.device_type == DeviceType.CPU
                  and a.self_device_time_total > 0),
                 key=lambda kv: -kv[1])
    return busy_us, ops


def trace_serving(torch, run, images):
    """torch.profiler trace of the serving loop (a run separate from the
    timed one): the share of the wall time in which some kernel ran on
    the card, and device time per operator, per batch."""
    from torch.profiler import ProfilerActivity, profile

    from abcnet_tpu_torch.__main__ import img2smiles_loop

    n_batches = len(images) // BATCH
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        img2smiles_loop(run, images, BATCH, log_every=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, ops = trace_summary(prof, n_batches)
    emit("serving_trace", ok=True, batches=n_batches,
         device_busy_share=busy_us / wall_us if busy_us else None,
         device_ms_per_batch=busy_us / 1e3 / n_batches,
         top_ops_device_ms_per_batch=dict(ops[:12]),
         note="trace of a separate loop run; busy = union of kernel spans "
              "over the loop's wall time")

# ---------------------------------------------------------------------------
# Training phases
# ---------------------------------------------------------------------------

def fixture_samples(fixture, labels):
    """The 64 fixture molecules as raw Samples (drawing + label strings)."""
    import hashlib

    from abcnet_tpu_torch.data.pipeline import Sample

    digest = hashlib.sha256(fixture["images"].tobytes()).hexdigest()
    if digest != str(labels["images_sha256"]):
        raise AssertionError("the training fixture's labels belong to other "
                             "drawings than the serving fixture holds")
    return [Sample(img, str(a), str(b), str(smi)) for img, a, b, smi in
            zip(fixture["images"], labels["atoms_string"],
                labels["bonds_string"], labels["smiles"])]


def phase_train_f32(torch, samples, labels):
    """eval_step in f32 (TF32 off) on the snapshot weights, rows 0-15,
    against the JAX package's f32 CPU losses for the same batch."""
    import random

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.models.weights import load_snapshot
    from abcnet_tpu_torch.train import trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.float32)
    state = trainer.create_state(trainer.TrainConfig(dtype="float32"), model)
    rng = random.Random(0)
    rows = labels["eval_rows"].tolist()
    batch = trainer.to_device(pipeline.collate(
        [pipeline.sample_to_example(samples[i], rng, train=False)
         for i in rows]), "cuda")
    total, losses, metrics = trainer.eval_step(state, batch)
    want = dict(zip(labels["eval_loss_names"].tolist(),
                    labels["eval_losses"].tolist()))
    want["total"] = float(labels["eval_total"])
    got = {k: float(v) for k, v in losses.items()}
    got["total"] = float(total)
    # relative, with an absolute floor of 1e-7 for a term that is 0 (no
    # atom of these rows carries an hs label)
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-7 / EVAL_REL_TOL)
           for k in want}
    ok = all(v <= EVAL_REL_TOL for v in rel.values()) and \
        all(bool(torch.isfinite(n)) for n, _ in metrics.values())
    emit("train_f32", ok=ok, rows=len(rows), port=got, jax_f32_cpu=want,
         rel_err=rel, gate=f"rel_err <= {EVAL_REL_TOL} per term",
         n_metrics=len(metrics))
    if not ok:
        raise AssertionError("f32 eval_step disagrees with the JAX losses")


def phase_train_bf16(torch, fixture, samples):
    """The production training setting through fit's loop, then the
    weights through the snapshot layout into the serving pipeline."""
    import random
    import tempfile

    from abcnet_tpu_torch.__main__ import img2smiles_loop
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models.weights import load_snapshot, save_snapshot
    from abcnet_tpu_torch.ops.noise import unpack_noise
    from abcnet_tpu_torch.ops.peaks import nms_topk
    from abcnet_tpu_torch.ops.unpack import unpack_bits
    from abcnet_tpu_torch.train import trainer

    cfg = trainer.TrainConfig(batch_size=BATCH, epochs=TRAIN_STEPS,
                              eval_every=TRAIN_STEPS, seed=0)
    rng = random.Random(0)
    test = [pipeline.sample_to_example(s, rng, train=False)
            for s in samples[:cfg.eval_batch_size]]
    state = trainer.create_state(cfg)
    bn = state.model.inc1.bn0
    bn_before = (bn.running_mean.clone(), bn.running_var.clone())

    # fit calls the module's train_step and train_metrics_step; wrap them
    # to keep each step's losses (device tensors, read after the loop) and
    # to count the forward passes that take noisy input.
    totals, terms, noisy = [], [], [0]
    step_fn, metrics_fn = trainer.train_step, trainer.train_metrics_step

    def recording_step(*a, **kw):
        out = step_fn(*a, **kw)
        totals.append(out[1])
        terms.append(out[2])
        noisy[0] += 1
        return out

    def counting_metrics(*a, **kw):
        noisy[0] += 1
        return metrics_fn(*a, **kw)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in (unpack_noise, unpack_bits, nms_topk):
        fn.launches = 0
    trainer.train_step, trainer.train_metrics_step = \
        recording_step, counting_metrics
    t0 = time.perf_counter()
    try:
        state = trainer.fit(cfg, samples, test, state=state, verbose=False)
    finally:
        trainer.train_step, trainer.train_metrics_step = step_fn, metrics_fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"unpack_noise": unpack_noise.launches,
                "unpack_bits": unpack_bits.launches,
                "nms_topk": nms_topk.launches}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    total_list = [float(t) for t in totals]
    finite = all(bool(torch.isfinite(v)) for d in terms for v in d.values()) \
        and all(t == t and abs(t) != float("inf") for t in total_list)
    bn_moved = not torch.equal(bn.running_mean, bn_before[0]) and \
        not torch.equal(bn.running_var, bn_before[1])
    fell = total_list[-1] < TRAIN_LOSS_FRACTION * total_list[0]
    ok = (finite and bn_moved and fell and state.step == TRAIN_STEPS
          and launches["unpack_noise"] == noisy[0]
          and launches["unpack_bits"] == 1 and launches["nms_topk"] == 0)

    # Weights through the npz snapshot layout into the serving pipeline.
    with tempfile.TemporaryDirectory() as tmp:
        path = save_snapshot(state.model, os.path.join(tmp, "smoke.npz"),
                             step=state.step)
        served, step = load_snapshot(path, "cuda", torch.bfloat16)
    same = all(torch.equal(v, served.state_dict()[k])
               for k, v in state.model.state_dict().items()
               if not k.endswith("num_batches_tracked"))
    preds = img2smiles_loop(make_infer_pipeline(served, "cuda"),
                            list(fixture["images"]), BATCH, log_every=0)
    ok = ok and same and step == TRAIN_STEPS and len(preds) == BATCH
    emit("train_bf16", ok=ok, batch=BATCH, steps=state.step,
         params=sum(p.numel() for p in state.model.parameters()),
         total_first=total_list[0], total_last=total_list[-1],
         totals=total_list, gate=f"finite; last < {TRAIN_LOSS_FRACTION} x "
         "first; BN running stats moved; unpack_noise launches == noisy "
         "forward passes; unpack_bits launches == 1 (the evaluation)",
         all_finite=finite, bn_running_stats_moved=bn_moved,
         noisy_forward_passes=noisy[0], launches=launches,
         last_terms={k: float(v) for k, v in terms[-1].items()},
         wall_s=wall, img_per_s_incl_warmup=TRAIN_STEPS * BATCH / wall,
         peak_mem_gib=peak_gib, snapshot_roundtrip_equal=same,
         served_decoded=sum(p is not None for p in preds))
    if not ok:
        raise AssertionError("bf16 training below its gates")
    return state, cfg, launches


def train_stage_breakdown(torch, state, batch, reps=5):
    """Device time per stage of one training step at batch 64 (CUDA
    events between the stages of trainer.train_step, launched as it
    launches them), median of `reps`; and of the sampled metrics step."""
    import numpy as np

    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.ops import losses as L
    from abcnet_tpu_torch.ops.targets import build_targets
    from abcnet_tpu_torch.train import trainer

    model, opt = state.model, state.optimizer
    names = ("input_kernel", "targets", "forward", "losses", "backward",
             "adam")
    res = {n: [] for n in names}
    res["step"], res["metrics_step"] = [], []
    for rep in range(reps + 1):
        gen = torch.Generator(device="cuda").manual_seed(rep)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(8)]
        torch.cuda.synchronize()
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        images = pipeline.device_unpack_bits(
            batch["image_bits"], train=True, dtype=model.dtype, amount=0.2,
            generator=gen)
        ev[1].record()
        targets = build_targets(batch, with_full_type=False)
        ev[2].record()
        model.train()
        preds = model(images, generator=gen)
        ev[3].record()
        total = L.total_loss(L.compute_losses(preds, targets, batch), model.s)
        ev[4].record()
        total.backward()
        ev[5].record()
        opt.step()
        ev[6].record()
        del images, targets, preds, total
        trainer.train_metrics_step(state, batch, rep)
        ev[7].record()
        torch.cuda.synchronize()
        if rep == 0:
            continue                       # warm-up
        for j, n in enumerate(names):
            res[n].append(ev[j].elapsed_time(ev[j + 1]))
        res["step"].append(ev[0].elapsed_time(ev[6]))
        res["metrics_step"].append(ev[6].elapsed_time(ev[7]))
    return {n: float(np.median(v)) for n, v in res.items()}


def phase_train_times(torch, samples, state, cfg, kernels):
    import random

    from torch.profiler import ProfilerActivity, profile

    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.ops.noise import unpack_noise
    from abcnet_tpu_torch.train import trainer

    rng = random.Random(1)
    batch = trainer.to_device(pipeline.collate(
        [pipeline.sample_to_example(s, rng, train=True) for s in samples]),
        "cuda")
    stages = train_stage_breakdown(torch, state, batch)

    # The fit loop with its host feed (augment, collate, prefetch thread,
    # pinned copies), warm: 10 more steps of the same state.
    more = 10
    cfg.epochs = state.step + more
    cfg.eval_every = 10 ** 9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    unpack_noise.launches = 0
    t0 = time.perf_counter()
    trainer.fit(cfg, samples, None, state=state, verbose=False)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step = unpack_noise.launches / more

    n_trace = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n_trace):
            trainer.train_step(state, batch, i, with_metrics=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy_us, ops = trace_summary(prof, n_trace)
    noise = next(k for k in kernels if k["name"] == "unpack_noise")
    emit("train_times", ok=True, batch=BATCH, stages_ms=stages,
         fit_loop_steps=more, fit_loop_img_per_s=more * BATCH / loop_s,
         fit_loop_ms_per_step=loop_s / more * 1e3,
         peak_mem_gib=peak_gib,
         noise_kernel={"ms": noise["ms"], "plain_ms": noise["plain_ms"],
                       "bound_ms": noise["bound_ms"],
                       "bound_by": noise["bound_by"],
                       "launches_per_step_incl_metrics": per_step,
                       "library_ms": None},
         trace_steps=n_trace,
         device_busy_share=busy_us / wall_us if busy_us else None,
         device_ms_per_step=busy_us / 1e3 / n_trace,
         top_ops_device_ms_per_step=dict(ops[:16]),
         note="stages: CUDA events inside one step, median of 5; fit loop: "
              "host feed included, metrics step every 5th step; trace: 3 "
              "train_steps on one resident batch")


# ---------------------------------------------------------------------------
# Slice 4: device guard, data parallel, mesh serving, variants, int8
# ---------------------------------------------------------------------------

def reset_launches():
    from abcnet_tpu_torch.ops.noise import unpack_noise
    from abcnet_tpu_torch.ops.peaks import nms_topk
    from abcnet_tpu_torch.ops.unpack import unpack_bits
    for fn in (unpack_bits, unpack_noise, nms_topk):
        fn.launches = 0


def read_launches():
    from abcnet_tpu_torch.ops.noise import unpack_noise
    from abcnet_tpu_torch.ops.peaks import nms_topk
    from abcnet_tpu_torch.ops.unpack import unpack_bits
    return {"unpack_bits": unpack_bits.launches,
            "unpack_noise": unpack_noise.launches,
            "nms_topk": nms_topk.launches}


def phase_device_guard(torch):
    """Every kernel wrapper on the last visible GPU while GPU 0 is the
    current device, bit-equal to its plain version there."""
    import numpy as np

    from abcnet_tpu_torch.data.pipeline import draw_noise_rates
    from abcnet_tpu_torch.ops.noise import (int32_probe, unpack_noise,
                                            unpack_noise_plain)
    from abcnet_tpu_torch.ops.peaks import (nms_topk, nms_topk_pair,
                                            null_launch)
    from abcnet_tpu_torch.ops.unpack import unpack_bits, unpack_bits_plain

    gpus = torch.cuda.device_count()
    dev = torch.device("cuda", gpus - 1)
    torch.cuda.set_device(0)
    rng = np.random.default_rng(3)
    bits = torch.from_numpy(rng.integers(0, 256, (BATCH, 512, 64),
                                         dtype=np.uint8)).to(dev)
    checked = []
    for dt in (torch.bfloat16, torch.float32):
        if not torch.equal(unpack_bits(bits, dt), unpack_bits_plain(bits, dt)):
            raise AssertionError(f"unpack_bits on {dev} differs")
        rates = draw_noise_rates(BATCH, 0.2, dev, torch.Generator(
            device=dev).manual_seed(0))
        for seed in (0, 43100):
            got = unpack_noise(bits, rates, seed, dt)
            if got.device != dev or not torch.equal(
                    got, unpack_noise_plain(bits, rates, seed, dt)):
                raise AssertionError(f"unpack_noise on {dev} differs")
        checked += [f"unpack_bits/{str(dt)[6:]}", f"unpack_noise/{str(dt)[6:]}"]
    for name, maps, thr in _peak_cases(torch)[:2]:
        for dt in (torch.float32, torch.bfloat16):
            m = maps.to(dev, dt)
            _, _, all_idx = check_nms(torch, m, 128, thr)
            err, pair_idx = check_nms_pair(torch, m, m, thr)
            if not (all_idx and pair_idx) or err:
                raise AssertionError(f"nms_topk on {dev} differs ({name})")
            checked += [f"nms_topk/{name}/{str(dt)[6:]}",
                        f"nms_topk_pair/{name}/{str(dt)[6:]}"]
    null_launch(BATCH, 128, 128, 160, maps=2, device=dev)
    probe = torch.empty(SMS * 256, dtype=torch.int32, device=dev)
    int32_probe(probe, 4)
    torch.cuda.synchronize(dev)
    checked += ["null_launch", "int32_probe"]
    if torch.cuda.current_device() != 0:
        raise AssertionError("a kernel wrapper changed the current device")
    emit("device_guard", ok=True, gpus=gpus, device=str(dev),
         current_device=0, checked=checked,
         note=("one GPU: the kernels ran on it, the guard across devices is "
               "not exercised" if gpus == 1 else
               "kernels launched on the last GPU with GPU 0 current"))


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def f32_ddp_step(torch, samples, mesh=None):
    """One f32 train_step (TF32 off, noise and dropout off) from the
    snapshot weights on the first DDP_BATCH_F32 fixture molecules
    (this rank's rows under a mesh). Returns a flat dict of numpy arrays:
    losses, gradients, running statistics."""
    import random

    import numpy as np

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.models.unet import OutConv
    from abcnet_tpu_torch.models.weights import load_snapshot, to_flax
    from abcnet_tpu_torch.parallel import shard_batch
    from abcnet_tpu_torch.train import trainer

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    drop, OutConv.DROP = OutConv.DROP, 0.0
    try:
        model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.float32)
        cfg = trainer.TrainConfig(dtype="float32", batch_size=DDP_BATCH_F32)
        state = trainer.create_state(cfg, model, mesh=mesh)
        rng = random.Random(0)
        host = pipeline.collate([pipeline.sample_to_example(s, rng,
                                                            train=False)
                                 for s in samples[:DDP_BATCH_F32]])
        if mesh is not None:
            host = shard_batch(host, mesh)
        _, total, losses, _ = trainer.train_step(
            state, trainer.to_device(host, state.device), rng=0, amount=0.0,
            with_metrics=False)
        out = {"loss/total": np.float64(float(total))}
        out.update({f"loss/{k}": np.float64(float(v))
                    for k, v in losses.items()})
        grads = to_flax({n: p.grad for n, p in model.named_parameters()})[0]
        out.update({f"grad/{k}": v for k, v in _flat_tree(grads).items()})
        out.update({f"stat/{k}": v for k, v in
                    _flat_tree(to_flax(model.state_dict())[1]).items()})
    finally:
        OutConv.DROP = drop
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    return out


def ddp_worker(out_path, backend):
    """One rank of the ddp_train phase (started by phase_ddp_train with
    RANK, WORLD_SIZE, LOCAL_RANK and MASTER_* in its environment)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from abcnet_tpu_torch.parallel import init_distributed, make_mesh
    from abcnet_tpu_torch.train import trainer

    rank = int(os.environ["RANK"])
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if backend == "gloo":
        dist.init_process_group("gloo", rank=rank,
                                world_size=int(os.environ["WORLD_SIZE"]))
        mesh = make_mesh(device="cuda")
    else:
        mesh = init_distributed("cuda")
    assets = os.path.join(HERE, "abcnet_tpu_torch", "assets")
    fixture = dict(np.load(os.path.join(assets, "smoke_step43100.npz")))
    labels = dict(np.load(os.path.join(assets, "train_step43100.npz")))
    samples = fixture_samples(fixture, labels)
    out = f32_ddp_step(torch, samples, mesh)
    torch.cuda.empty_cache()

    cfg = trainer.TrainConfig(batch_size=DDP_BATCH_BF16, epochs=DDP_STEPS,
                              eval_every=10 ** 9, seed=0)
    state = trainer.create_state(cfg, mesh=mesh)
    totals, times = [], []
    step_fn = trainer.train_step

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step_fn(*a, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        totals.append(float(res[1]))
        return res

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    trainer.train_step = timed_step
    t0 = time.perf_counter()
    try:
        trainer.fit(cfg, samples, None, state=state, verbose=False)
    finally:
        trainer.train_step = step_fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    checksum = sum(float(p.double().sum()) for p in state.model.parameters())
    out.update({
        "bf16/totals": np.asarray(totals), "bf16/step_ms": np.asarray(times),
        "bf16/fit_wall_s": np.float64(wall),
        "bf16/peak_mem_gib": np.float64(torch.cuda.max_memory_allocated()
                                        / 2 ** 30),
        "bf16/param_checksum": np.float64(checksum),
        "bf16/local_batch": np.int64(DDP_BATCH_BF16 // mesh.world),
        **{f"launches/{k}": np.int64(v) for k, v in launches.items()}})
    np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


def phase_ddp_train(torch, samples):
    import socket
    import tempfile

    import numpy as np

    gpus = torch.cuda.device_count()
    backend = "nccl" if gpus >= 2 else "gloo"
    ref = f32_ddp_step(torch, samples)
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(2):
            env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
                   "LOCAL_RANK": str(rank if gpus >= 2 else 0),
                   "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--ddp-worker",
                 os.path.join(tmp, f"rank{rank}.npz"), backend],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"a ddp rank failed:\n{log[-4000:]}")
        r0, r1 = (dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                  for r in range(2))

    loss_rel = {k[5:]: abs(float(r0[k]) - float(ref[k])) /
                max(abs(float(ref[k])), 1e-6)
                for k in ref if k.startswith("loss/")}
    grads = [k for k in ref if k.startswith("grad/")]
    norms = {k: float(np.linalg.norm(ref[k])) for k in grads}
    top = max(norms.values())
    leaf = {k[5:]: float(np.linalg.norm(r0[k] - ref[k])) / norms[k]
            for k in grads if norms[k] > 1e-3 * top}
    tree = float(np.sqrt(sum(float(np.sum((r0[k] - ref[k]) ** 2))
                             for k in grads))
                 / np.sqrt(sum(n * n for n in norms.values())))
    stats = [k for k in ref if k.startswith("stat/")]
    stat_err = max(float(np.max(np.abs(r0[k] - ref[k])
                                / (np.abs(ref[k]) + 1e-3))) for k in stats)
    ranks_equal = all(np.array_equal(r0[k], r1[k]) for k in stats + grads) \
        and float(r0["bf16/param_checksum"]) == float(r1["bf16/param_checksum"])
    totals = r0["bf16/totals"].tolist()
    finite = bool(np.all(np.isfinite(r0["bf16/totals"])))
    ok = (max(loss_rel.values()) <= DDP_LOSS_REL and
          max(leaf.values()) <= DDP_GRAD_LEAF and tree <= DDP_GRAD_TREE and
          stat_err <= DDP_STAT_REL and ranks_equal and finite and
          len(totals) == DDP_STEPS and
          int(r0["launches/unpack_noise"]) >= DDP_STEPS)
    per_rank = [{"peak_mem_gib": float(r["bf16/peak_mem_gib"]),
                 "step_ms_median_2_to_10": float(np.median(
                     r["bf16/step_ms"][1:])),
                 "step_ms": r["bf16/step_ms"].tolist(),
                 "fit_wall_s": float(r["bf16/fit_wall_s"]),
                 "local_batch": int(r["bf16/local_batch"]),
                 "launches": {k[9:]: int(v) for k, v in r.items()
                              if k.startswith("launches/")}}
                for r in (r0, r1)]
    emit("ddp_train", ok=ok, ranks=2, gpus=gpus, backend=backend,
         f32_global_batch=DDP_BATCH_F32, loss_rel_err=loss_rel,
         grad_leaf_rel_err_max=max(leaf.values()),
         grad_leaf_worst=max(leaf, key=leaf.get), grad_tree_rel_err=tree,
         running_stats_rel_err_max=stat_err,
         ranks_bit_equal=ranks_equal,
         gate=f"losses <= {DDP_LOSS_REL}, leaves <= {DDP_GRAD_LEAF}, tree <= "
              f"{DDP_GRAD_TREE}, stats <= {DDP_STAT_REL} relative; ranks "
              "bit-equal; bf16 totals finite",
         bf16_global_batch=DDP_BATCH_BF16, bf16_steps=DDP_STEPS,
         bf16_totals=totals, per_rank=per_rank,
         note=("both ranks share one card over gloo: a check of the "
               "algorithm, not a speed figure" if backend == "gloo" else
               "NCCL, one GPU per rank"))
    if not ok:
        raise AssertionError("data-parallel training differs from one "
                             "process")
    return {k: int(v) for k, v in per_rank[0]["launches"].items()}


def phase_mesh_serving(torch, fixture, bf16_model):
    """make_infer_pipeline over every visible GPU (on a one-GPU machine:
    MESH_BLOCKS row blocks on that GPU). Gate: peak dicts bit-equal to
    the unsharded pipeline run on each row block alone (the per-device
    shapes), and SMILES agreeing with the unsharded run of the whole
    batch. Against that whole-batch run the peaks are reported, not
    gated bit for bit: cuDNN picks its conv algorithm by batch size, so
    the trunk of a 16-row block may differ from that of 64 rows in the
    last bits (`trunk_max_abs_diff_vs_whole_batch`)."""
    import numpy as np

    from abcnet_tpu_torch.__main__ import img2smiles_loop
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.infer.decode import (DENSE_HEADS_SPARSE_MODE,
                                               make_infer_pipeline)
    from abcnet_tpu_torch.ops.unpack import unpack_bits
    from abcnet_tpu_torch.parallel import Mesh, make_mesh

    gpus = torch.cuda.device_count()
    mesh = make_mesh(device="cuda") if gpus > 1 else \
        Mesh((torch.device("cuda", 0),) * MESH_BLOCKS)
    n = len(mesh.devices)
    images = fixture["images"]
    whole = make_infer_pipeline(bf16_model, "cuda")
    want = whole(images)
    parts = [whole(block) for block in np.split(images, n)]
    blockwise = {k: np.concatenate([p[k] for p in parts]) for k in want}
    masks = unpack_bits(torch.from_numpy(pack_images(images)).cuda())[..., None]
    with torch.no_grad():
        def trunk(x):
            heads, feats = bf16_model(x, dense_heads=DENSE_HEADS_SPARSE_MODE,
                                      return_features=True)
            return [feats] + [heads[k] for k in sorted(heads)]
        ref = trunk(masks)
        blocks = [trunk(m) for m in masks.chunk(n)]
        trunk_diff = max(float((torch.cat(b) - r).abs().max())
                         for r, b in zip(ref, zip(*blocks)))
    run = make_infer_pipeline(bf16_model, "cuda", mesh=mesh)
    reset_launches()
    got = run(images)
    torch.cuda.synchronize()
    launches = read_launches()
    equal = sorted(got) == sorted(blockwise) and all(
        np.array_equal(got[k], blockwise[k]) for k in blockwise)
    vs_whole = {k: int(np.sum(got[k] != want[k])) for k in want}
    float_diff = max(float(np.max(np.abs(got[k].astype(np.float64)
                                         - want[k])))
                     for k in want if want[k].dtype.kind == "f")
    smiles = img2smiles_loop(run, list(images), BATCH, log_every=0)
    smiles_whole = img2smiles_loop(whole, list(images), BATCH, log_every=0)
    agree = sum(a == b for a, b in zip(smiles, smiles_whole))
    fresh = [np.roll(images, s, axis=2) for s in range(1, 9)]
    run(fresh[0])
    t0 = time.perf_counter()
    for batch in fresh:
        run(batch)
    img_s = len(fresh) * BATCH / (time.perf_counter() - t0)
    ok = equal and agree >= BATCH - MESH_SMILES_SLACK and \
        launches["unpack_bits"] == n and launches["nms_topk"] == n
    emit("mesh_serving", ok=ok, gpus=gpus, devices=[str(d) for d in
                                                    mesh.devices],
         batch=BATCH, peaks_equal_blockwise=equal,
         entries_differing_vs_whole_batch=vs_whole,
         float_max_abs_diff_vs_whole_batch=float_diff,
         trunk_max_abs_diff_vs_whole_batch=trunk_diff,
         smiles_agree_with_whole_batch=agree, launches_per_batch=launches,
         pipeline_img_per_s=img_s,
         gate=f"peak dicts equal to the unsharded pipeline on each row block; "
              f"SMILES of >= {BATCH - MESH_SMILES_SLACK}/{BATCH} equal to the "
              "whole-batch run; one unpack and one NMS launch per device per "
              "batch",
         note="img/s: dispatch + fetch per batch over 8 fresh batches, no "
              "assembly" + ("" if gpus > 1 else
                            f"; one GPU: {MESH_BLOCKS} row blocks on it"))
    if not ok:
        raise AssertionError("mesh serving differs from the unsharded run")
    return launches


def multiproc_worker(out_path, backend):
    """One rank of the multiproc_serving phase (started by
    phase_multiproc_serving with RANK, WORLD_SIZE, LOCAL_RANK and MASTER_*
    in its environment): the snapshot in bf16 (rank 1 moves MOVED_STAT
    first), make_infer_pipeline on the rank's mesh, the rank's rows of the
    fixture batch (`local_rows`) through the CLI's serving loop with the
    rank's own assembly pool, then dispatch + fetch img/s."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT, img2smiles_loop
    from abcnet_tpu_torch.infer.assemble import (assemble_batch,
                                                 make_assembly_pool)
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models.weights import load_snapshot
    from abcnet_tpu_torch.parallel import (init_distributed, local_rows,
                                           make_mesh)

    rank = int(os.environ["RANK"])
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if backend == "gloo":
        dist.init_process_group("gloo", rank=rank,
                                world_size=int(os.environ["WORLD_SIZE"]))
        mesh = make_mesh(device="cuda")
    else:
        mesh = init_distributed("cuda")
    model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.bfloat16)
    if mesh.rank:
        with torch.no_grad():
            model.state_dict()[MOVED_STAT].add_(0.25)
    run = make_infer_pipeline(model, "cuda", mesh=mesh)
    checksum = sum(float(t.double().sum())
                   for t in model.state_dict().values())
    fixture = np.load(os.path.join(HERE, "abcnet_tpu_torch", "assets",
                                   "smoke_step43100.npz"))
    images = fixture["images"][local_rows(len(fixture["images"]), mesh)]
    served = []
    pool = make_assembly_pool(MULTIPROC_POOL)
    try:
        def assemble(peaks):
            served.append(peaks)
            return assemble_batch(peaks, pool=pool)

        torch.cuda.synchronize()
        reset_launches()
        smiles = img2smiles_loop(run, list(images), len(images),
                                 log_every=0, assemble=assemble)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        pool.close()
        pool.join()
    fresh = [np.roll(images, s, axis=2) for s in range(1, 9)]
    run(fresh[0])
    dist.barrier()
    t0 = time.perf_counter()
    for batch in fresh:
        run(batch)
    img_s = len(fresh) * len(images) / (time.perf_counter() - t0)
    np.savez(out_path, **{f"peaks/{k}": v for k, v in served[0].items()},
             smiles=np.array([p or "" for p in smiles]),
             **{f"launches/{k}": np.int64(v) for k, v in launches.items()},
             batches=np.int64(len(served)), checksum=np.float64(checksum),
             moved=model.state_dict()[MOVED_STAT].float().cpu().numpy(),
             rows=np.int64(len(images)), img_s=np.float64(img_s),
             device=str(mesh.device))
    dist.barrier()
    dist.destroy_process_group()


def phase_multiproc_serving(torch, fixture, bf16_model, bf16_preds):
    """Two ranks of a process group, each serving its own rows through
    make_infer_pipeline(mesh=the rank's mesh) (NCCL on two GPUs, or both
    ranks on the one card over gloo). Gates: each rank's peak dict
    bit-equal to this process's unsharded pipeline on the same row block;
    the SMILES of both ranks against the whole-batch serving run; one
    unpack and one NMS launch per rank per batch; both ranks hold rank 0's
    weights (equal checksums, rank 1's moved statistic restored)."""
    import socket
    import tempfile

    import numpy as np

    from abcnet_tpu_torch.infer.decode import make_infer_pipeline

    gpus = torch.cuda.device_count()
    backend = "nccl" if gpus >= MULTIPROC_RANKS else "gloo"
    images = fixture["images"]
    whole = make_infer_pipeline(bf16_model, "cuda")
    blocks = [whole(b) for b in np.split(images, MULTIPROC_RANKS)]
    snap_stat = bf16_model.state_dict()[MOVED_STAT].float().cpu().numpy()
    torch.cuda.synchronize()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for rank in range(MULTIPROC_RANKS):
            env = {**os.environ, "RANK": str(rank),
                   "WORLD_SIZE": str(MULTIPROC_RANKS),
                   "LOCAL_RANK": str(rank if backend == "nccl" else 0),
                   "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--multiproc-worker", os.path.join(tmp, f"rank{rank}.npz"),
                 backend],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"a serving rank failed:\n{log[-4000:]}")
        ranks = [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                 for r in range(MULTIPROC_RANKS)]
    wall = time.perf_counter() - t0
    per_rank, equal, launches_ok = [], [], []
    for r, (got, want) in enumerate(zip(ranks, blocks)):
        peaks = {k[6:]: v for k, v in got.items() if k.startswith("peaks/")}
        same = sorted(peaks) == sorted(want) and all(
            peaks[k].dtype == want[k].dtype
            and np.array_equal(peaks[k], want[k]) for k in want)
        launches = {k[9:]: int(v) for k, v in got.items()
                    if k.startswith("launches/")}
        n_batches = int(got["batches"])
        equal.append(same)
        launches_ok.append(n_batches == 1 and launches == {
            "unpack_bits": 1, "unpack_noise": 0, "nms_topk": 1})
        per_rank.append({"device": str(got["device"]),
                         "rows": int(got["rows"]), "batches": n_batches,
                         "peaks_equal_blockwise": same,
                         "launches": launches,
                         "dispatch_fetch_img_per_s": float(got["img_s"]),
                         "param_checksum": float(got["checksum"])})
    smiles = [s for got in ranks for s in got["smiles"].tolist()]
    agree = sum(a == b for a, b in zip(smiles, bf16_preds))
    replicated = all(np.array_equal(got["moved"], snap_stat)
                     for got in ranks) and \
        len({float(got["checksum"]) for got in ranks}) == 1
    ok = (all(equal) and all(launches_ok) and replicated
          and len(smiles) == len(images)
          and agree >= len(images) - MESH_SMILES_SLACK)
    emit("multiproc_serving", ok=ok, ranks=MULTIPROC_RANKS, gpus=gpus,
         backend=backend, global_batch=len(images),
         assembly_pool_per_rank=MULTIPROC_POOL, per_rank=per_rank,
         smiles_agree_with_whole_batch=agree,
         replicated_rank0_weights=replicated, wall_s=wall,
         gate="each rank's peak dict bit-equal to the unsharded pipeline on "
              "its row block; SMILES of >= "
              f"{len(images) - MESH_SMILES_SLACK}/{len(images)} equal to the "
              "whole-batch run; one unpack and one NMS launch per rank per "
              "batch; both ranks hold rank 0's weights",
         note="img/s: dispatch + fetch of 8 fresh batches of a rank's rows, "
              "no assembly, both ranks at once" + (
                  "; both ranks share one card over gloo: no speed figure "
                  "of multi-GPU serving" if backend == "gloo" else
                  "; NCCL, one GPU per rank"))
    if not ok:
        raise AssertionError("multi-process serving differs from the "
                             "unsharded run")
    return {f"multiproc_serving_rank{r}": p["launches"]
            for r, p in enumerate(per_rank)}


def _train_variant(torch, trainer, model, batch, steps, rng0=0):
    """`steps` train_steps of `model` (bf16, batch 64) on one resident
    batch. Returns (state, totals, first step's losses, ms per step,
    peak GiB)."""
    cfg = trainer.TrainConfig(batch_size=BATCH)
    state = trainer.create_state(cfg, model=model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals, times, first = [], [], None
    for i in range(steps):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        _, total, losses, _ = trainer.train_step(state, batch, rng0 + i,
                                                 with_metrics=False)
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
        totals.append(float(total))
        if first is None:
            first = {k: float(v) for k, v in losses.items()}
    return (state, totals, first, times,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def phase_variants(torch, fixture, samples):
    import random

    import numpy as np

    from abcnet_tpu_torch.__main__ import img2smiles_loop
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.infer.decode import make_infer_pipeline
    from abcnet_tpu_torch.models import UNet, UNetCBAM, UNetS2D
    from abcnet_tpu_torch.models.fuse_heads import fuse_head_variables
    from abcnet_tpu_torch.models.unet import OutConv
    from abcnet_tpu_torch.models.weights import from_flax, to_flax
    from abcnet_tpu_torch.train import trainer

    rng = random.Random(2)
    batch = trainer.to_device(pipeline.collate(
        [pipeline.sample_to_example(s, rng, train=True) for s in samples]),
        "cuda")
    bf16 = torch.bfloat16

    def seeded(make):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            return make()

    rows, launches, ok = {}, {}, True
    for name, make in (("s2d", lambda: UNetS2D(dtype=bf16)),
                       ("cbam", lambda: UNetCBAM(dtype=bf16))):
        model = seeded(make)
        reset_launches()
        state, totals, _, times, peak = _train_variant(
            torch, trainer, model, batch, VARIANT_STEPS)
        launches[f"{name}_train"] = read_launches()
        fell = all(np.isfinite(totals)) and totals[-1] < totals[0]
        rows[name] = {"params": sum(p.numel() for p in model.parameters()),
                      "totals": totals, "loss_fell": fell,
                      "step_ms_median_2_on": float(np.median(times[1:])),
                      "step_ms": times, "peak_mem_gib": peak,
                      "train_launches": launches[f"{name}_train"]}
        ok = ok and fell and \
            launches[f"{name}_train"]["unpack_noise"] == VARIANT_STEPS
        if name == "s2d":
            reset_launches()
            preds = img2smiles_loop(make_infer_pipeline(model.eval(), "cuda"),
                                    list(fixture["images"]), BATCH,
                                    log_every=0)
            torch.cuda.synchronize()
            launches["s2d_serving"] = read_launches()
            served = launches["s2d_serving"]["unpack_bits"] == 1 and \
                launches["s2d_serving"]["nms_topk"] == 1 and \
                len(preds) == BATCH
            rows[name]["served"] = len(preds)
            rows[name]["serving_launches"] = launches["s2d_serving"]
            ok = ok and served
        del state, model
        torch.cuda.empty_cache()

    # Production UNet, its fused head bank and remat on the same weights:
    # a first step with dropout off (the fused bank draws one mask over
    # 1024 channels, the heads eight over 128: other masks), then steps
    # with dropout for the time and memory.
    plain = seeded(lambda: UNet(dtype=bf16))
    params, stats = to_flax(plain.state_dict())
    fused_tree = fuse_head_variables({"params": params, "batch_stats": stats})
    makers = {
        "plain": lambda: plain,
        "fused_head_bank": lambda: UNet(dtype=bf16, fused_head_bank=True),
        "remat_blocks": lambda: UNet(dtype=bf16,
                                     remat_blocks=UNet.BLOCKS + ("heads",)),
    }
    firsts = {}
    for name, make in makers.items():
        model = make()
        if name == "fused_head_bank":
            model.load_state_dict(from_flax(fused_tree["params"],
                                            fused_tree["batch_stats"]))
        elif name == "remat_blocks":
            model.load_state_dict(from_flax(params, stats))
        drop, OutConv.DROP = OutConv.DROP, 0.0
        try:
            state, first_total, first, _, _ = _train_variant(
                torch, trainer, model, batch, 1, rng0=100)
        finally:
            OutConv.DROP = drop
        firsts[name] = (first_total[0], first)
        del state
        model = make()
        if name == "fused_head_bank":
            model.load_state_dict(from_flax(fused_tree["params"],
                                            fused_tree["batch_stats"]))
        elif name == "remat_blocks":
            model.load_state_dict(from_flax(params, stats))
        state, totals, _, times, peak = _train_variant(
            torch, trainer, model, batch, VARIANT_STEPS)
        rows[name] = {"first_step_total_dropout_off": firsts[name][0],
                      "totals": totals,
                      "step_ms_median_2_on": float(np.median(times[1:])),
                      "step_ms": times, "peak_mem_gib": peak}
        del state, model
        torch.cuda.empty_cache()
    base = firsts["plain"][1]
    for name, tol in (("fused_head_bank", FUSED_LOSS_REL),
                      ("remat_blocks", 0.0)):
        rel = {k: abs(v - base[k]) / max(abs(base[k]), 1e-6)
               for k, v in firsts[name][1].items()}
        rows[name]["first_step_loss_rel_err_vs_plain"] = rel
        ok = ok and max(rel.values()) <= tol
    emit("variants", ok=ok, batch=BATCH, dtype="bfloat16", size=512,
         steps=VARIANT_STEPS, rows=rows,
         gate=f"S2D and CBAM finite with the loss falling, one noise launch "
              f"a step; S2D serves with one unpack and one NMS launch; "
              f"first-step losses: remat equal, fused within "
              f"{FUSED_LOSS_REL} relative",
         note="5 train_steps on one resident batch of the 64 fixture "
              "molecules, noise on, seeded init; ms: CUDA events, median of "
              "steps 2-5")
    if not ok:
        raise AssertionError("a model variant failed its gates")
    return launches


def phase_quant_serving(torch, fixture, bf16_model, bf16_preds):
    import numpy as np

    from abcnet_tpu_torch.__main__ import img2smiles_loop
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.eval.scoring import score_pairs
    from abcnet_tpu_torch.infer import quant
    from abcnet_tpu_torch.infer.decode import (DENSE_HEADS_SPARSE_MODE,
                                               make_infer_pipeline)
    from abcnet_tpu_torch.ops.unpack import unpack_bits

    images = fixture["images"]
    bits = torch.from_numpy(pack_images(images)).cuda()
    masks = unpack_bits(bits, torch.float32)[..., None]
    t0 = time.perf_counter()
    bundle = quant.prepare_quant(bf16_model, masks[:32])
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    run = make_infer_pipeline(bf16_model, "cuda", quant=bundle)
    reset_launches()
    preds = [p or "" for p in img2smiles_loop(run, list(images), BATCH,
                                              log_every=0)]
    torch.cuda.synchronize()
    launches = read_launches()
    truth = fixture["truth"].tolist()
    q_rep = score_pairs(truth, [p or None for p in preds])
    b_rep = score_pairs(truth, [p or None for p in bf16_preds])
    agree = sum(p == b for p, b in zip(preds, bf16_preds))

    carry = masks.to(torch.bfloat16)
    with torch.no_grad():
        int8_ms = device_ms(torch, lambda: quant.forward_quant(bundle, carry),
                            reps=5)
        bf16_ms = device_ms(torch, lambda: bf16_model(
            carry, dense_heads=DENSE_HEADS_SPARSE_MODE,
            return_features=True), reps=5)

    # int32 accumulators against a float64 convolution of the same int8
    # tensors on the card: exact, as the sums stay far below 2^53.
    gen = torch.Generator(device="cuda").manual_seed(5)
    exact = {}
    for site, layer, shape in (("up1.0", bundle["up1"]["dc"][0][0],
                                (BATCH, 32, 32, 512)),
                               ("inc1.1", bundle["inc1"][1][0],
                                (4, 512, 512, 16)),
                               ("up1.t", bundle["up1"]["t"][0],
                                (BATCH, 16, 16, 512))):
        xq = torch.randint(-127, 128, shape, generator=gen, device="cuda",
                           dtype=torch.int8)
        x64 = xq.double().permute(0, 3, 1, 2)
        if site.endswith(".t"):
            got = quant.convt_int8(xq, layer)
            w = torch.flip(layer.double(), (0, 1)).permute(2, 3, 0, 1)
            want = torch.nn.functional.conv_transpose2d(x64, w, stride=2)
        else:
            got = quant.conv_int8(xq, layer)
            want = torch.nn.functional.conv2d(
                x64, layer.double().permute(3, 2, 0, 1), padding=1)
        want = want.permute(0, 2, 3, 1)
        exact[site] = {"k": int(layer.shape[0] * layer.shape[1]
                                * layer.shape[2]),
                       "max_abs_acc": int(got.abs().max()),
                       "equal": bool(torch.equal(got.double(), want))}
    ok = (all(e["equal"] for e in exact.values()) and
          q_rep.exact_match >= b_rep.exact_match - QUANT_EXACT_SLACK and
          launches["unpack_bits"] == 1 and launches["nms_topk"] == 1)
    emit("quant_serving", ok=ok, n=len(truth), calibration_images=32,
         prepare_s=prep_s, int8_exact=q_rep.exact_match,
         bf16_exact=b_rep.exact_match, agree_with_bf16=agree,
         int8=str(q_rep), bf16=str(b_rep), launches=launches,
         int8_backbone_ms=int8_ms, bf16_trunk_ms=bf16_ms,
         int32_vs_float64_conv=exact,
         gate=f"int8 exact >= bf16 exact - {QUANT_EXACT_SLACK:.4f}; int32 "
              "accumulators equal to a float64 conv; one unpack and one NMS "
              "launch",
         note="backbone ms: forward_quant vs the bf16 UNet trunk + heatmap "
              "heads on the same 64 masks, median of 5 CUDA-event timings")
    if not ok:
        raise AssertionError("int8 serving below its gates")
    return launches


# ---------------------------------------------------------------------------
# Slice 5: the generator, the n=256 evaluation, the CLI loop
# ---------------------------------------------------------------------------

def _sha(b):
    import hashlib

    import numpy as np
    return np.frombuffer(hashlib.sha256(b).digest(), np.uint8)


def _sample_digests(s):
    """(image, atoms, bonds, smiles) sha256 digests of a Sample (of b"" for
    None), as tests/test_torch_gen_fixture.py makes them."""
    import numpy as np
    if s is None:
        return [_sha(b"")] * 4
    return [_sha(np.ascontiguousarray(s.image).tobytes()),
            _sha(s.atoms_string.encode()), _sha(s.bonds_string.encode()),
            _sha(s.smiles.encode())]


def _digest_check(generate_sample, z):
    """The port's streams and corpus against gen_digests.npz: per stream,
    samples whose labels and SMILES are equal, images equal, attempts and
    the rng state after the stream; per corpus entry the same."""
    import random

    import numpy as np

    fields = ("image", "atoms", "bonds", "smiles")
    n = z["image"].shape[1]
    streams = []
    for i, (mode, engine, seed) in enumerate(zip(
            z["modes"].tolist(), z["engines"].tolist(), z["seeds"].tolist())):
        rng = random.Random(seed)
        got, attempts = [], 0
        while len(got) < n:
            s = generate_sample(rng, mode=mode, engine=engine)
            attempts += 1
            if s is not None:
                got.append(_sample_digests(s))
        eq = {f: sum(np.array_equal(g[j], z[f][i, k])
                     for k, g in enumerate(got))
              for j, f in enumerate(fields)}
        streams.append({
            "mode": mode, "engine": engine, "seed": seed, "n": n,
            "labels_smiles_equal": min(eq["atoms"], eq["bonds"],
                                       eq["smiles"]),
            "images_equal": eq["image"],
            "attempts_equal": attempts == int(z["attempts"][i]),
            "rng_equal": bool(np.array_equal(
                _sha(repr(rng.getstate()).encode()), z["rng"][i]))})
    rng = random.Random(31)                       # CORPUS_SEED of the fixture
    found = [generate_sample(rng, smiles=smi) for smi in z["corpus"].tolist()]
    corpus = {"n": len(found),
              "truth_equal": sum((s.smiles if s else "") == t for s, t in
                                 zip(found, z["corpus_truth"].tolist()))}
    for j, f in enumerate(fields):
        corpus[f"{f}_equal"] = sum(
            np.array_equal(_sample_digests(s)[j], z[f"corpus_{f}"][k])
            for k, s in enumerate(found))
    return streams, corpus


def _examples_check():
    """generate_examples over a spawn pool on the card's host against the
    serial concatenation of its chunks (_gen_chunk(seed + 7919·w, ...),
    every image, label array and SMILES) and against the JAX package's
    list for the same arguments (assets/examples_digests.npz: labels and
    SMILES gated, images counted as engine A's drawings are); the rate of
    the pool and of one thread."""
    import numpy as np

    from abcnet_tpu_torch.data.pipeline import _gen_chunk, generate_examples

    z = np.load(os.path.join(HERE, "abcnet_tpu_torch", "assets",
                             "examples_digests.npz"))
    n, seed, procs = int(z["n"]), int(z["seed"]), int(z["processes"])
    mode, train = str(z["mode"]), bool(z["train"])
    t0 = time.perf_counter()
    pooled = generate_examples(n, seed, mode, train, processes=procs)
    pool_s = time.perf_counter() - t0
    chunk = -(-n // procs)
    t0 = time.perf_counter()
    serial = [e for w in range(procs) if w * chunk < n for e in _gen_chunk(
        seed + 7919 * w, min(chunk, n - w * chunk), mode, train)]
    serial_s = time.perf_counter() - t0
    equal = len(pooled) == len(serial) == n and all(
        np.array_equal(a.image_u8, b.image_u8) and a.smiles == b.smiles
        and sorted(a.labels) == sorted(b.labels) and all(
            a.labels[k].dtype == b.labels[k].dtype
            and np.array_equal(a.labels[k], b.labels[k]) for k in b.labels)
        for a, b in zip(pooled, serial))

    def labels_bytes(labels):
        return b"".join(k.encode() + str(v.dtype).encode() +
                        str(v.shape).encode() +
                        np.ascontiguousarray(v).tobytes()
                        for k, v in sorted(labels.items()))

    vs_jax = {
        "labels_equal": sum(np.array_equal(_sha(labels_bytes(e.labels)), d)
                            for e, d in zip(pooled, z["labels"])),
        "smiles_equal": sum(e.smiles == str(m)
                            for e, m in zip(pooled, z["smiles"])),
        "images_bit_equal": sum(
            np.array_equal(_sha(np.ascontiguousarray(e.image_u8).tobytes()),
                           d) for e, d in zip(pooled, z["image"]))}
    # the rate of a larger list over the default pool (cpu_count - 2)
    t0 = time.perf_counter()
    big = generate_examples(EXAMPLES_BIG_N, seed, mode, train)
    big_s = time.perf_counter() - t0
    ok = equal and vs_jax["labels_equal"] == vs_jax["smiles_equal"] == n \
        and len(big) == EXAMPLES_BIG_N
    return ok, {"n": n, "seed": seed, "mode": mode, "train": train,
                "processes": procs, "pool_equal_to_chunks": equal,
                "vs_jax_digests": vs_jax, "pool_s": pool_s,
                "one_thread_s": serial_s,
                "pool_samples_per_s": n / pool_s,
                "one_thread_samples_per_s": n / serial_s,
                "default_pool": {"n": EXAMPLES_BIG_N,
                                 "processes": max(1, (os.cpu_count() or 4)
                                                  - 2),
                                 "s": big_s,
                                 "samples_per_s": EXAMPLES_BIG_N / big_s}}


def phase_generator(torch):
    """The port's generator on the card's host (no GPU work): the two
    held-out pools of final_eval against the truths of the TPU's results
    CSV, the fixture molecules' labels and drawings, the digest fixture of
    every (mode, engine) stream and the corpus mode; the generation rate."""
    import csv

    import numpy as np
    import PIL
    from PIL import features

    from abcnet_tpu_torch.data.generate import (generate_sample,
                                                generate_samples)
    from abcnet_tpu_torch.eval.final_eval import POOLS

    assets = os.path.join(HERE, "abcnet_tpu_torch", "assets")
    fixture = np.load(os.path.join(assets, "smoke_step43100.npz"))
    labels = np.load(os.path.join(assets, "train_step43100.npz"))
    t0 = time.perf_counter()
    pools = {mode: generate_samples(GEN_POOL_N, seed, mode)
             for mode, seed in POOLS}
    gen_s = time.perf_counter() - t0
    with open(os.path.join(HERE, "logs", "final_eval_step43100.csv"),
              newline="") as f:
        rows = list(csv.DictReader(f))
    # the CSV holds the rdkit pool in rows 0-255, the indigo pool after it
    truths_equal = sum(s.smiles == rows[256 * j + i]["smiles"]
                       for j, (mode, _) in enumerate(POOLS)
                       for i, s in enumerate(pools[mode]))
    n_pooled = sum(len(p) for p in pools.values())
    first = [s for mode, _ in POOLS for s in pools[mode][:32]]
    labels_equal = sum(
        s.atoms_string == str(a) and s.bonds_string == str(b)
        and s.smiles == str(m) for s, a, b, m in zip(
            first, labels["atoms_string"], labels["bonds_string"],
            labels["smiles"]))
    shares = [float(np.mean(s.image != img))
              for s, img in zip(first, fixture["images"])]
    z = np.load(os.path.join(assets, "gen_digests.npz"))
    t0 = time.perf_counter()
    streams, corpus = _digest_check(generate_sample, z)
    digest_s = time.perf_counter() - t0
    n_digest = sum(s["n"] for s in streams) + corpus["n"]
    b_equal = all(s["images_equal"] == s["n"] for s in streams
                  if s["engine"] == "b")
    labels_all = all(s["labels_smiles_equal"] == s["n"] and s["attempts_equal"]
                     and s["rng_equal"] for s in streams) and \
        corpus["truth_equal"] == corpus["n"] == corpus["atoms_equal"] \
        == corpus["bonds_equal"] == corpus["smiles_equal"]
    examples_ok, examples = _examples_check()
    ok = (truths_equal == n_pooled == 2 * GEN_POOL_N
          and labels_equal == len(first) and max(shares) < PIXEL_SHARE_MAX
          and b_equal and labels_all and examples_ok)
    emit("generator", ok=ok, pools={m: len(p) for m, p in pools.items()},
         truths_equal_tpu_csv=truths_equal, csv_rows=len(rows),
         fixture_labels_smiles_equal=labels_equal, fixture_n=len(first),
         fixture_images_bit_equal=sum(x == 0 for x in shares),
         fixture_max_differing_pixel_share=max(shares),
         pillow=PIL.__version__, freetype=features.version("freetype2"),
         digest_streams=streams, digest_corpus=corpus,
         engine_b_images_bit_equal=b_equal,
         samples_per_s=(n_pooled + n_digest) / (gen_s + digest_s),
         pools_s=gen_s, digest_s=digest_s, generate_examples=examples,
         gate=f"truths {2 * GEN_POOL_N}/{2 * GEN_POOL_N} equal to "
              "logs/final_eval_step43100.csv; fixture labels and SMILES "
              f"64/64; every fixture image differs in < {PIXEL_SHARE_MAX} "
              "of its pixels; every stream's and corpus entry's labels, "
              "SMILES, attempts and rng state equal to the digests; engine "
              "b images bit-equal; generate_examples over a spawn pool "
              "equal to the serial concatenation of its chunks, its labels "
              "and SMILES equal to the JAX package's list "
              "(assets/examples_digests.npz)",
         note="one host thread of the card's machine; samples_per_s over "
              "the pools and the digest streams; generate_examples: "
              "examples (train augmentation and labels included) per "
              "second with the pool, its spawn included, and on one thread")
    if not ok:
        raise AssertionError("the port's generator differs from the JAX "
                             "package's data")
    return pools


def phase_final_eval(torch, pools):
    """eval.final_eval in bf16 on the snapshot: per lineage the heatmap
    metric suite through trainer.eval_step at batch 16, then the serving
    loop at batch 16 with the sub-cell and the integer-cell assembler;
    overall scores and the row-by-row agreement with the TPU's
    smiles_pred of logs/final_eval_step43100.csv."""
    import csv

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.eval import final_eval as fe
    from abcnet_tpu_torch.eval.scoring import score_pairs
    from abcnet_tpu_torch.models.weights import load_snapshot

    def report(r):
        return {"exact": r.exact_match,
                "exact_canonical": r.exact_match_canonical,
                "exact_isomeric": r.exact_match_isomeric,
                "dice": r.tanimoto_like, "decode_rate": r.decode_rate,
                "n": r.n}

    model, step = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = fe.evaluate(model, pools=pools, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    per_lineage = {mode: {"heatmap": r.heatmap, "e2e": report(r.e2e),
                          "e2e_int_cell": report(r.e2e_int),
                          "serve_s": r.serve_s}
                   for mode, r in results.items()}
    truths, preds, preds_int = fe.overall(results)
    allrep, allrep_int = score_pairs(truths, preds), \
        score_pairs(truths, preds_int)
    with open(os.path.join(HERE, "logs", "final_eval_step43100.csv"),
              newline="") as f:
        rows = list(csv.DictReader(f))
    # the TPU's answer for each served row: rdkit in CSV rows 0-255, indigo
    # after them
    tpu = [rows[256 * j + i]["smiles_pred"]
           for j, res in enumerate(results.values())
           for i in range(len(res.truths))]
    agree = sum((p or "") == t for p, t in zip(preds, tpu))
    # every lineage's pool is a whole number of batches: each batch is
    # unpacked once for the heatmap metrics and once for serving, and its
    # two heatmaps go through one NMS launch
    n_batches = len(truths) // fe.EVAL_BATCH
    ok = (allrep.exact_match >= FINAL_EVAL_TPU_EXACT - FINAL_EVAL_SLACK
          and allrep.decode_rate >= FINAL_EVAL_DECODE_MIN
          and launches["unpack_bits"] == 2 * n_batches
          and launches["nms_topk"] == n_batches
          and launches["unpack_noise"] == 0)
    emit("final_eval", ok=ok, snapshot_step=step, dtype="bfloat16",
         batch=fe.EVAL_BATCH, per_lineage=per_lineage,
         overall=report(allrep), overall_int_cell=report(allrep_int),
         agree_with_tpu_smiles_pred=agree, n=len(truths),
         tpu_reference={"exact": FINAL_EVAL_TPU_EXACT, "rdkit": 0.8906,
                        "indigo": 0.7852, "decode_rate": 1.0,
                        "source": "logs/final_eval_r5e.log"},
         batches=n_batches, launches=launches, wall_s=wall,
         gate=f"overall exact >= {FINAL_EVAL_TPU_EXACT} - {FINAL_EVAL_SLACK} "
              f"(the TPU's); decode rate >= {FINAL_EVAL_DECODE_MIN}; per "
              "batch of 16 one unpack launch for the heatmap metrics, and "
              "one unpack and one NMS launch for serving",
         mismatched_vs_tpu=[{"row": i, "port": p, "tpu": t} for i, (p, t)
                            in enumerate(zip(preds, tpu)) if (p or "") != t])
    if not ok:
        raise AssertionError("the n=256 evaluation is below its gates")
    return launches


def _cli(argv):
    """abcnet_tpu_torch's main(argv) with its standard output captured."""
    import contextlib
    import io

    from abcnet_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    return buf.getvalue()


def _score_fields(line):
    """{field: value} of a printed ScoreReport line."""
    return {k: float(v) for k, v in (t.split("=") for t in line.split())}


def serve_and_score_checkpoint(torch, ds, ck, tmp, module, times, by_path):
    """img2smiles --ckpt CK and test-acc --ckpt CK on the gen set `ds`
    through main(), the serving pipeline's host peak dicts and test-acc's
    counts recorded on the way, against the same two paths on `module`,
    the model fit left in memory. Launches counted under
    img2smiles_ckpt and test_acc_ckpt."""
    import random

    import numpy as np

    from abcnet_tpu_torch import __main__ as cli
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.infer import decode

    served, counted = [], []
    make, totals = decode.make_infer_pipeline, cli.per_class_totals

    def recording_pipeline(*a, **kw):
        run = make(*a, **kw)
        fetch = run.fetch

        def fetch_and_keep(handle):
            served.append(fetch(handle))
            return served[-1]
        run.fetch = fetch_and_keep
        return run

    def recording_totals(*a, **kw):
        counted.append(totals(*a, **kw))
        return counted[-1]

    decode.make_infer_pipeline = recording_pipeline
    cli.per_class_totals = recording_totals
    try:
        reset_launches()
        t0 = time.perf_counter()
        serve_out = _cli(["img2smiles", "--data", ds, "--ckpt", ck,
                          "--out", os.path.join(tmp, "results_ck.csv")])
        torch.cuda.synchronize()
        times["img2smiles_ckpt"] = time.perf_counter() - t0
        by_path["img2smiles_ckpt"] = read_launches()
        reset_launches()
        t0 = time.perf_counter()
        test_acc_out = _cli(["test-acc", "--data", ds, "--ckpt", ck])
        torch.cuda.synchronize()
        times["test_acc_ckpt"] = time.perf_counter() - t0
        by_path["test_acc_ckpt"] = read_launches()
    finally:
        decode.make_infer_pipeline, cli.per_class_totals = make, totals
    first = serve_out.strip().splitlines()[0]
    printed = int(first.rsplit("(step ", 1)[1].rstrip(")"))
    images, _ = pipeline.load_image_csv(os.path.join(ds, "dataset.csv"))
    batch = 64                                # img2smiles' default -b
    n_serve = -(-len(images) // batch)
    run = make(module, "cuda")
    want = [run(np.stack(images[i:i + batch]))
            for i in range(0, len(images), batch)]
    peaks_equal = len(served) == len(want) and all(
        sorted(g) == sorted(w) and all(
            g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
            for k in w) for g, w in zip(served, want))
    rng = random.Random(0)
    examples = [pipeline.sample_to_example(s, rng, train=False) for s in
                pipeline.load_csv_dataset(os.path.join(ds, "dataset.csv"))]
    batch_acc = 16                            # test-acc's default -b
    want_counts = totals(module, examples, batch_acc)
    counts_equal = len(counted) == 1 and sorted(counted[0]) == \
        sorted(want_counts) and all(
            torch.equal(a, b) for g in want_counts
            for a, b in zip(counted[0][g], want_counts[g]))
    n_acc = len(examples) // batch_acc
    launches_ok = (by_path["img2smiles_ckpt"] == {
        "unpack_bits": n_serve, "unpack_noise": 0, "nms_topk": n_serve}
        and by_path["test_acc_ckpt"] == {
            "unpack_bits": n_acc, "unpack_noise": 0, "nms_topk": 0})
    return {"ok": peaks_equal and counts_equal and launches_ok,
            "weights_line": first, "printed_step": printed,
            "serving_batches": n_serve, "peaks_equal_in_memory": peaks_equal,
            "test_acc_batches": n_acc, "counts_equal_in_memory": counts_equal,
            "score": _score_fields(serve_out.strip().splitlines()[-1]),
            "test_acc_report_lines": len(test_acc_out.strip().splitlines())}


def phase_cli_loop(torch):
    """gen -> train --synthetic -> img2smiles -> test-acc -> cal-acc (truths
    as SMILES and as InChI) through the port's main() in a temporary
    directory; then test-acc's counting in f32 on fixture rows 0-15 against
    the JAX package's counts (assets/test_acc_step43100.npz)."""
    import csv
    import random
    import tempfile

    import numpy as np

    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT, per_class_totals
    from abcnet_tpu_torch.chem.inchi import smiles_to_inchi
    from abcnet_tpu_torch.data import pipeline
    from abcnet_tpu_torch.data.generate import Sample
    from abcnet_tpu_torch.models.weights import load_snapshot
    from abcnet_tpu_torch.train import trainer

    by_path, times = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        ds = os.path.join(tmp, "ds")
        t0 = time.perf_counter()
        _cli(["gen", "--out", ds, "-n", "64", "--engine", "mix",
              "--seed", "0"])
        times["gen"] = time.perf_counter() - t0
        with open(os.path.join(ds, "dataset.csv"), newline="") as f:
            n_gen = sum(1 for _ in csv.DictReader(f))

        # train --synthetic: every step's losses kept (fit calls the
        # module's train_step), the noise kernel's launches counted, the
        # state that fit returns kept
        totals, terms, noisy, fitted = [], [], [0], []
        step_fn, metrics_fn = trainer.train_step, trainer.train_metrics_step
        fit_fn = trainer.fit

        def recording_step(*a, **kw):
            out = step_fn(*a, **kw)
            totals.append(float(out[1]))
            terms.append({k: float(v) for k, v in out[2].items()})
            noisy[0] += 1
            return out

        def counting_metrics(*a, **kw):
            noisy[0] += 1
            return metrics_fn(*a, **kw)

        def keeping_fit(*a, **kw):
            fitted.append(fit_fn(*a, **kw))
            return fitted[-1]

        ck = os.path.join(tmp, "ck")
        trainer.train_step, trainer.train_metrics_step, trainer.fit = \
            recording_step, counting_metrics, keeping_fit
        reset_launches()
        t0 = time.perf_counter()
        try:
            train_out = _cli(["train", "--synthetic", "256", "-b", "64",
                              "--epochs", "1", "--ckpt", ck])
        finally:
            trainer.train_step, trainer.train_metrics_step, trainer.fit = \
                step_fn, metrics_fn, fit_fn
        torch.cuda.synchronize()
        times["train_synthetic"] = time.perf_counter() - t0
        by_path["gen_train_synthetic"] = read_launches()
        ckpts = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
        finite = bool(totals) and all(
            np.isfinite(t) for t in totals) and all(
            np.isfinite(v) for d in terms for v in d.values())

        results = os.path.join(tmp, "results.csv")
        reset_launches()
        t0 = time.perf_counter()
        serve_out = _cli(["img2smiles", "--data", ds, "--out", results])
        torch.cuda.synchronize()
        times["img2smiles"] = time.perf_counter() - t0
        by_path["img2smiles_gen"] = read_launches()
        serve_score = _score_fields(serve_out.strip().splitlines()[-1])

        reset_launches()
        t0 = time.perf_counter()
        test_acc_out = _cli(["test-acc", "--data", ds])
        torch.cuda.synchronize()
        times["test_acc"] = time.perf_counter() - t0
        by_path["test_acc"] = read_launches()

        trained = fitted[0]
        ckpt = serve_and_score_checkpoint(torch, ds, ck, tmp, trained.model,
                                          times, by_path)
        ckpt["fit_step"] = trained.step
        del fitted, trained
        torch.cuda.empty_cache()

        inchi_csv = os.path.join(tmp, "results_inchi.csv")
        with open(results, newline="") as f:
            rows = list(csv.DictReader(f))
        with open(inchi_csv, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(["", "InChI", "smiles_pred"])
            for r in rows:
                w.writerow([r[""], smiles_to_inchi(r["smiles"]),
                            r["smiles_pred"]])
        t0 = time.perf_counter()
        cal = _score_fields(_cli(["cal-acc", results]).strip())
        cal_inchi = _score_fields(_cli(["cal-acc", inchi_csv]).strip())
        times["cal_acc_both"] = time.perf_counter() - t0

    # test-acc's counting in f32, TF32 off, on fixture rows 0-15
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    assets = os.path.join(HERE, "abcnet_tpu_torch", "assets")
    fixture = np.load(os.path.join(assets, "smoke_step43100.npz"))
    labels = np.load(os.path.join(assets, "train_step43100.npz"))
    want = np.load(os.path.join(assets, "test_acc_step43100.npz"))
    rows16 = int(want["rows"])
    rng = random.Random(0)
    examples = [pipeline.sample_to_example(
        Sample(fixture["images"][i], str(labels["atoms_string"][i]),
               str(labels["bonds_string"][i]), str(labels["smiles"][i])),
        rng, train=False) for i in range(rows16)]
    model, _ = load_snapshot(DEFAULT_SNAPSHOT, "cuda", torch.float32)
    got = {k: torch.stack(v).numpy() for k, v in per_class_totals(
        model, examples, int(want["batch"])).items()}
    count_diff = {g: int(np.abs(got[g] - want[f"counts_{g}"]).max())
                  for g in want["groups"].tolist()}
    count_ok = all(
        (np.abs(got[g] - want[f"counts_{g}"])
         <= np.maximum(TESTACC_ABS, TESTACC_REL * want[f"counts_{g}"])).all()
        for g in want["groups"].tolist())

    steps = len(totals)
    noise = by_path["gen_train_synthetic"]["unpack_noise"]
    same_metrics = ("exact_canonical", "decode_rate", "n", "decoded")
    ok = (n_gen == 64 and finite and steps > 0 and noise == noisy[0]
          and bool(ckpts) and "exact" in serve_score
          and "== atom_type ==" in test_acc_out and count_ok
          and all(cal[k] == cal_inchi[k] for k in same_metrics)
          and cal == serve_score and ckpt["ok"]
          and ckpt["printed_step"] == ckpt["fit_step"] == steps)
    emit("cli_loop", ok=ok, gen_n=n_gen,
         train={"steps": steps, "noisy_forward_passes": noisy[0],
                "totals": totals, "finite": finite, "checkpoints": ckpts,
                "first_line": train_out.strip().splitlines()[0]
                if train_out.strip() else ""},
         img2smiles=serve_score, cal_acc_smiles=cal, cal_acc_inchi=cal_inchi,
         trained_checkpoint=ckpt,
         test_acc_report_lines=len(test_acc_out.strip().splitlines()),
         test_acc_f32_rows=rows16, test_acc_f32_counts=
         {g: v.tolist() for g, v in got.items()},
         test_acc_f32_max_count_diff_vs_jax=count_diff,
         launches_by_path=by_path, times_s=times,
         gate="gen wrote 64; finite losses; unpack_noise launches == noisy "
              "forward passes; a checkpoint; img2smiles scored, cal-acc of "
              "its CSV prints its score; the InChI truths give the same "
              "exact_canonical, decode rate, n and decoded (the InChI reader "
              "drops stereo layers, so the stereo-aware exact, "
              "exact_isomeric and dice are reported only); the f32 counts "
              f"within max({TESTACC_ABS}, {TESTACC_REL} x count) of the JAX "
              "package's; img2smiles and test-acc --ckpt of the checkpoint "
              "directory load the step fit ended at, their peak dicts and "
              "counts equal to the module fit left in memory, bit for bit, "
              "one unpack and one NMS launch per serving batch, one unpack "
              "per test-acc batch")
    if not ok:
        raise AssertionError("the CLI loop failed its gates")
    return by_path


def bench_probe_worker(out_path, train_batch):
    """The bench's train steps at `train_batch` in a process of their own
    (phase_bench): the step ms and peak memory, or the out-of-memory and
    the peak reached before it."""
    import torch

    sys.path.insert(0, HERE)
    from abcnet_tpu_torch import bench

    res = {"train_batch": int(train_batch)}
    torch.cuda.reset_peak_memory_stats()
    try:
        step_s, peak = bench.train_bench(int(train_batch), "cuda",
                                         torch.bfloat16)
        res.update(fits=True, train_step_ms=step_s * 1e3, peak_gib=peak)
    except torch.cuda.OutOfMemoryError as e:
        res.update(fits=False,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   error=str(e).splitlines()[0][:400])
    res["card_gib"] = torch.cuda.get_device_properties(0).total_memory \
        / 2 ** 30
    with open(out_path, "w") as f:
        json.dump(res, f)


def _bench_cli(argv):
    """`python -m abcnet_tpu_torch bench ARGV` through the CLI's main() in
    this process: (exit code, record, seconds)."""
    import contextlib
    import io

    from abcnet_tpu_torch.__main__ import main as cli_main

    buf, code = io.StringIO(), 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        try:
            cli_main(["bench", *argv])
        except SystemExit as e:
            code = e.code
    lines = buf.getvalue().strip().splitlines()
    return code or 0, json.loads(lines[-1]), time.perf_counter() - t0


def phase_bench_probe(torch):
    """The JAX bench's train batch (BENCH_JAX_TRAIN_BATCH) probed in a
    process of its own, so that an out-of-memory spoils nothing after it:
    the step ms and peak memory, or the out-of-memory and the peak before
    it. Runs only when named (`--phases bench_probe`); its one reading
    chose bench's --train-batch default (BENCH_TRAIN_BATCH), whose help
    text carries it."""
    import tempfile

    torch.cuda.empty_cache()
    parent_reserved_gib = torch.cuda.memory_reserved() / 2 ** 30
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "probe.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--bench-probe", out,
             str(BENCH_JAX_TRAIN_BATCH)], capture_output=True, text=True,
            timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0 or not os.path.exists(out):
            raise RuntimeError(f"the train batch {BENCH_JAX_TRAIN_BATCH} "
                               f"probe failed: {proc.stderr[-3000:]}")
        with open(out) as f:
            probe = json.load(f)
    emit("bench_probe", probe=probe, seconds=seconds,
         parent_reserved_gib=parent_reserved_gib)


def phase_bench(torch):
    """The `bench` sub-command: `bench` (sparse, then its train steps at
    the default --train-batch) and `bench --dense --skip-train` through
    the CLI's main(), then the bench's train steps alone, launch counts
    set to 0 before each and read after it; the records gated; the
    bench's serving program on the clean-carry batch of buffer 0 against
    make_infer_pipeline on its images, with the weights the records
    name."""
    import math

    import numpy as np

    from abcnet_tpu_torch import bench
    from abcnet_tpu_torch.__main__ import DEFAULT_SNAPSHOT
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.infer.decode import (make_infer_pipeline,
                                               sparse_heads)

    times = {}
    calls = min(bench.WARMUP, bench.N_BUFFERS) + 3 * bench.ITERS + 3
    records, by_path, gates = {}, {}, {}
    for mode, argv in (("sparse", []), ("dense", ["--dense",
                                                  "--skip-train"])):
        torch.cuda.empty_cache()
        reset_launches()
        code, rec, times[mode] = _bench_cli(argv)
        n = read_launches()
        records[mode] = rec
        train = mode == "sparse"
        rates = ["value", "sync_ips", "e2e_smiles_ips"] + (
            ["train_step_ips"] if train else [])
        gates[mode] = {
            "exit_0_no_error": code == 0 and "error" not in rec,
            "rates_finite_positive": all(
                isinstance(rec.get(k), (int, float))
                and math.isfinite(rec[k]) and rec[k] > 0 for k in rates),
            "implied_tflops_le_peak": 0 < rec.get("implied_tflops", -1)
            <= bench.H100_PEAK_TFLOPS,
            "launches": n["unpack_bits"] == n["nms_topk"] == calls
            and n["unpack_noise"] == (bench.TRAIN_STEPS if train else 0),
            "weights_default_snapshot":
                (rec.get("weights") or {}).get("path") == DEFAULT_SNAPSHOT,
        }
        if train:
            gates[mode]["train_batch_default"] = \
                rec.get("train_batch") == BENCH_TRAIN_BATCH
        by_path[f"bench_{mode}"] = dict(n)
        emit("bench_record", mode=mode, exit_code=code, record=rec,
             launches=n, serving_calls=calls)

    # The train steps alone, so that their path's counts are read apart
    # from serving's.
    torch.cuda.empty_cache()
    reset_launches()
    t0 = time.perf_counter()
    step_s, peak = bench.train_bench(BENCH_TRAIN_BATCH, "cuda",
                                     torch.bfloat16)
    times["train"] = time.perf_counter() - t0
    n = read_launches()
    by_path["bench_train"] = dict(n)
    gates["train"] = {
        "launches": n["unpack_bits"] == n["nms_topk"] == 0
        and n["unpack_noise"] == bench.TRAIN_STEPS,
        "step_finite_positive": math.isfinite(step_s) and step_s > 0,
    }
    emit("bench_train", train_batch=BENCH_TRAIN_BATCH,
         train_step_ms=step_s * 1e3, train_peak_gib=peak, launches=n)

    # The clean-carry batch of buffer 0 is the served program's answer.
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    model, _ = bench.load_model(DEFAULT_SNAPSHOT, dev)
    images = bench.real_batch_images(9000, BATCH)
    bits = torch.from_numpy(pack_images(images, 0.6)).to(dev)
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    served = {}
    for mode in ("sparse", "dense"):
        heads = sparse_heads(model, model.dtype) if mode == "sparse" \
            else None
        got, _ = bench.serve_step(model, heads, bits, zero)
        got = {k: v.cpu().numpy() for k, v in got.items()}
        want = make_infer_pipeline(model, dev, sparse=mode == "sparse")(
            images)
        served[mode] = sorted(want) == sorted(got) and all(
            want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k])
            for k in want)
    times["served_check"] = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()

    ok = all(all(g.values()) for g in gates.values()) and all(
        served.values())
    emit("bench", ok=ok, gates=gates,
         clean_batch_equals_make_infer_pipeline=served,
         launches_by_path=by_path, times_s=times,
         gate="exit 0 and no error; value, sync_ips, e2e_smiles_ips (and "
              "train_step_ips) finite and > 0; 0 < implied_tflops <= "
              f"{bench.H100_PEAK_TFLOPS}; one unpack and one NMS launch per "
              f"call of the serving program ({calls}), one noise launch per "
              f"train step ({bench.TRAIN_STEPS}) in the sparse record and "
              f"in the train steps alone; the default train batch "
              f"{BENCH_TRAIN_BATCH}; the records' weights the default "
              "snapshot; the clean-carry peak dict of buffer 0 bit-equal "
              "to make_infer_pipeline on its images, sparse and dense")
    if not ok:
        raise AssertionError("the bench phase failed its gates")
    return by_path


def main(argv):
    if argv[:1] == ["--ddp-worker"]:
        ddp_worker(*argv[1:3])
        return 0
    if argv[:1] == ["--multiproc-worker"]:
        multiproc_worker(*argv[1:3])
        return 0
    if argv[:1] == ["--bench-probe"]:
        bench_probe_worker(*argv[1:3])
        return 0
    only = None
    if argv[:1] == ["--phases"]:
        only = set(argv[1].split(","))
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import numpy as np

        import abcnet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the abcnet_tpu_torch package is missing beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    assets = os.path.join(HERE, "abcnet_tpu_torch", "assets")
    phase = "environment"

    def want(name):
        return only is None or name in only

    try:
        fixture = dict(np.load(os.path.join(assets, "smoke_step43100.npz")))
        labels = dict(np.load(os.path.join(assets, "train_step43100.npz")))
        samples = fixture_samples(fixture, labels)
        phase_environment(torch)
        by_path = {}
        if want("device_guard"):
            phase = "device_guard"
            phase_device_guard(torch)
        if only is None:
            phase = "kernels_vs_plain"
            errs = phase_kernels(torch, fixture)
            phase = "serving_f32"
            phase_f32(torch, fixture)
        phase = "serving_bf16"
        model, run, launches, bf16_preds = phase_bf16(torch, fixture)
        by_path["img2smiles_bf16"] = dict(launches)
        if only is None:
            phase = "train_f32"
            phase_train_f32(torch, samples, labels)
            phase = "train_bf16"
            state, cfg, train_launches = phase_train_bf16(torch, fixture,
                                                          samples)
            launches["unpack_noise"] = train_launches["unpack_noise"]
            by_path["fit_bf16"] = dict(train_launches)
            phase = "times"
            kernels = phase_times(torch, fixture, model, run, launches, errs)
            phase = "train_times"
            phase_train_times(torch, samples, state, cfg, kernels)
            del state
            torch.cuda.empty_cache()
        if want("mesh_serving"):
            phase = "mesh_serving"
            by_path["mesh_serving"] = phase_mesh_serving(torch, fixture,
                                                         model)
        if want("multiproc_serving"):
            phase = "multiproc_serving"
            by_path.update(phase_multiproc_serving(torch, fixture, model,
                                                   bf16_preds))
        if want("quant_serving"):
            phase = "quant_serving"
            by_path["int8_serving"] = phase_quant_serving(
                torch, fixture, model, bf16_preds)
        del model, run
        torch.cuda.empty_cache()
        if want("variants"):
            phase = "variants"
            by_path.update(phase_variants(torch, fixture, samples))
        if want("ddp_train"):
            phase = "ddp_train"
            torch.cuda.empty_cache()
            by_path["ddp_fit_rank0"] = phase_ddp_train(torch, samples)
        if want("generator") or want("final_eval"):
            phase = "generator"
            pools = phase_generator(torch)
        if want("final_eval"):
            phase = "final_eval"
            torch.cuda.empty_cache()
            by_path["final_eval"] = phase_final_eval(torch, pools)
            del pools
        if want("cli_loop"):
            phase = "cli_loop"
            torch.cuda.empty_cache()
            by_path.update(phase_cli_loop(torch))
        if want("bench"):
            phase = "bench"
            torch.cuda.empty_cache()
            by_path.update(phase_bench(torch))
        if only is not None and "bench_probe" in only:
            phase = "bench_probe"
            phase_bench_probe(torch)
    except Exception as e:  # noqa: BLE001 — report the phase, then fail
        import traceback
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    if only is not None:
        print(json.dumps({"launches_by_path": by_path}), flush=True)
        print("chip_smoke: --phases ran a subset; no result line",
              file=sys.stderr)
        return 4
    for k in kernels:
        k["launches_by_path"] = {path: n.get(k["name"], 0)
                                 for path, n in by_path.items()}
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
