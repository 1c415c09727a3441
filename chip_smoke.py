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
  7. the card line of nvidia-smi, then the kernels line, then the result.

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
    return model, run, launches


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


def main():
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
    try:
        fixture = dict(np.load(os.path.join(assets, "smoke_step43100.npz")))
        labels = dict(np.load(os.path.join(assets, "train_step43100.npz")))
        samples = fixture_samples(fixture, labels)
        phase_environment(torch)
        phase = "kernels_vs_plain"
        errs = phase_kernels(torch, fixture)
        phase = "serving_f32"
        phase_f32(torch, fixture)
        phase = "serving_bf16"
        model, run, launches = phase_bf16(torch, fixture)
        phase = "train_f32"
        phase_train_f32(torch, samples, labels)
        phase = "train_bf16"
        state, cfg, train_launches = phase_train_bf16(torch, fixture,
                                                      samples)
        launches["unpack_noise"] = train_launches["unpack_noise"]
        phase = "times"
        kernels = phase_times(torch, fixture, model, run, launches, errs)
        phase = "train_times"
        phase_train_times(torch, samples, state, cfg, kernels)
    except Exception as e:  # noqa: BLE001 — report the phase, then fail
        import traceback
        traceback.print_exc()
        emit(phase, ok=False, error=f"{type(e).__name__}: {e}")
        return 1
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
