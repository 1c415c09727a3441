#!/usr/bin/env python3
"""Smoke run of the abcnet_tpu_torch serving path (img2smiles) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, one card

Drives the port's main path — bit pack, unpack kernel, production U-Net
on the step-43100 snapshot, NMS/top-K kernel, sparse heads, packed
transport, host assembly, scoring — on the 64-molecule fixture
abcnet_tpu_torch/assets/smoke_step43100.npz, and prints one JSON line
per phase:

  1. environment: the card, its power limit, the kernel and assembler
     builds (all compilers started at once);
  2. kernels against their plain PyTorch versions on the card, bit-equal
     (unpack on random and fixture bits; NMS/top-K on random, plateau,
     threshold, edge, constant and below-threshold maps, K = 128 and 160,
     f32 and bf16);
  3. f32 serving (TF32 off): SMILES against the JAX package's f32 SMILES,
     gate >= 62/64;
  4. bf16 serving, the production setting, through the CLI's serving
     loop at batch 64, with the kernels' launch counts set to 0 just
     before and read just after: exact match against the truth next to
     the TPU's, gate port >= TPU - 3/64;
  5. times on the card: each kernel and its plain version at the serving
     shapes (median of 25 CUDA-event timings, each launched behind a
     sleep kernel so the host's launch overhead is not timed), the bound
     from the bytes each must move, a per-stage breakdown of one batch,
     the serving loop's img/s at batch 64 on fresh input, and a
     torch.profiler trace of the loop (device busy share, device time
     per operator);
  6. the kernels line, then the card line of nvidia-smi, then the result.

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


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi failed: {out.stderr.strip()}"


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
    emit("environment", ok=True, device=torch.cuda.get_device_name(0),
         nvidia_smi=smi_line(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas,
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
    return cases


def check_nms(torch, maps, k, thr):
    """Kernel vs plain version on one batch of maps. Returns (max abs
    score difference over finite slots, slots compared). Raises if a
    score or an index differs."""
    from abcnet_tpu_torch.ops.peaks import nms_topk, nms_topk_plain
    s, i = nms_topk(maps, k, thr)
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

    nms_err, nms_cases = 0.0, []
    for name, maps, thr in _peak_cases(torch):
        for dt in (torch.float32, torch.bfloat16):
            m = maps.to(dev, dt)
            for k in (128, 160):
                err, n_finite, all_idx = check_nms(torch, m, k, thr)
                nms_err = max(nms_err, err)
                nms_cases.append({"case": name, "dtype": str(dt)[6:],
                                  "k": k, "finite_slots": n_finite,
                                  "all_indices_equal": all_idx})
    torch.cuda.synchronize()
    emit("kernels_vs_plain", ok=True, unpack_cases=unpack_cases,
         unpack_max_abs_err=unpack_err, nms_cases=nms_cases,
         nms_max_abs_err=nms_err)
    return {"unpack_bits": unpack_err, "nms_topk": nms_err}


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
    ok = (port_rep.exact_match >= tpu_rep.exact_match - 3 / 64
          and all(v > 0 for v in launches.values()))
    emit("serving_bf16", ok=ok, launches=launches,
         agree_with_tpu_bf16=agree, n=len(truth),
         port_exact=port_rep.exact_match, tpu_exact=tpu_rep.exact_match,
         gate="port_exact >= tpu_exact - 3/64", port=str(port_rep),
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
    from abcnet_tpu_torch.data.pipeline import pack_images
    from abcnet_tpu_torch.ops.peaks import nms_topk, nms_topk_plain
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
        err, _, _ = check_nms(torch, m, k, -1.0)
        errs["nms_topk"] = max(errs["nms_topk"], err)

    def both(fn):
        return lambda: (fn(a_map, 128, -1.0), fn(b_map, 160, -1.0))

    el = 2 if dt == torch.bfloat16 else 4
    unpack_bytes = bits.numel() + bits.numel() * 8 * el
    nms_bytes = (a_map.numel() + b_map.numel()) * el + BATCH * (128 + 160) * 8
    nms_ops = (a_map.numel() + b_map.numel()) * 9     # 3x3 compares
    rows = [
        ("unpack_bits", "abcnet_tpu_torch/csrc/unpack.cu",
         "abcnet_tpu/ops/pallas_input.py:59",
         lambda: unpack_bits(bits, dt), lambda: unpack_bits_plain(bits, dt),
         unpack_bytes, bits.numel() * 8,
         f"({BATCH},512,64) u8 -> ({BATCH},512,512) {str(dt)[6:]}"),
        ("nms_topk", "abcnet_tpu_torch/csrc/nms_topk.cu",
         "abcnet_tpu/ops/pallas_peaks.py:78",
         both(nms_topk), both(nms_topk_plain), nms_bytes, nms_ops,
         f"2 launches per batch: ({BATCH},128,128) {str(dt)[6:]} "
         "K=128 and K=160"),
    ]
    kernels = []
    for name, src, repl, kern, plain, nbytes, nops, shape in rows:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / F32_OPS_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": repl,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": device_ms(torch, kern), "plain_ms": device_ms(torch, plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "shape": shape})
    emit("kernel_times", ok=True, kernels=kernels)

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


def trace_serving(torch, run, images):
    """torch.profiler trace of the serving loop (a run separate from the
    timed one): the share of the wall time in which some kernel ran on
    the card, and device time per operator, per batch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from abcnet_tpu_torch.__main__ import img2smiles_loop

    n_batches = len(images) // BATCH
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        img2smiles_loop(run, images, BATCH, log_every=0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
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
    ops = sorted(((a.key, a.self_device_time_total / 1e3 / n_batches)
                  for a in prof.key_averages()
                  if a.device_type == DeviceType.CPU
                  and a.self_device_time_total > 0),
                 key=lambda kv: -kv[1])
    emit("serving_trace", ok=True, batches=n_batches,
         device_busy_share=busy_us / wall_us if spans else None,
         device_ms_per_batch=busy_us / 1e3 / n_batches,
         top_ops_device_ms_per_batch=dict(ops[:12]),
         note="trace of a separate loop run; busy = union of kernel spans "
              "over the loop's wall time")


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
    fixture_path = os.path.join(HERE, "abcnet_tpu_torch", "assets",
                                "smoke_step43100.npz")
    phase = "environment"
    try:
        fixture = dict(np.load(fixture_path))
        phase_environment(torch)
        phase = "kernels_vs_plain"
        errs = phase_kernels(torch, fixture)
        phase = "serving_f32"
        phase_f32(torch, fixture)
        phase = "serving_bf16"
        model, run, launches = phase_bf16(torch, fixture)
        phase = "times"
        kernels = phase_times(torch, fixture, model, run, launches, errs)
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
