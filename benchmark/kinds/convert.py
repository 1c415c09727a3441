"""Traffic kind `convert`: the CLI's conversion loop over the frozen pool.

What `python -m abcnet_tpu_torch img2smiles` does with a directory of
drawings, driven from here: `__main__.img2smiles_loop` over
`infer/decode.py:make_infer_pipeline` (host pack, pinned H2D, the device
program, packed D2H on a fetch thread) and `infer/assemble.py`'s host
assembly, in batches of the mix's `batch`, with an assembly pool of the
mix's `processes` (none at 0, the CLI's default).

The mix file holds: batch, processes, warm_batches (the batches timed to
size the window), trace_seconds (the length of the profiled window that
a --trace 1 run adds after the timed one), sample_batches (the batches
of the timed window compared with the reference).

Set-up: the pool of drawings (sha256 checked), the program's weights
from the configuration's snapshot, for the int8 backbone its
calibration on drawings the seed picks, the pipeline, the assembly pool,
two loops of warm-up. The window is closed-loop: the seed orders the
pool's drawings into as many batches as the warm-up rate fills
`--seconds` with.
"""

from __future__ import annotations

import gc
import os
import sys
import time
from contextlib import nullcontext
from typing import Dict, List

import numpy as np

from .. import check, harness, pool

def calibration_masks(images: np.ndarray, device):
    """The calibration drawings as (N, H, W, 1) float {0, 1} masks on
    `device`, what both sides are handed."""
    from ..reference.decode import binarize

    return binarize(images, device).permute(0, 2, 3, 1).contiguous()


class Program:
    """The system under test: the serving pipeline of a configuration,
    its assembly pool, and the program's default assembly."""

    def __init__(self, cfg: Dict, mix: Dict, calib, device: str = "cuda",
                 backbone: str = None):
        import torch

        from abcnet_tpu_torch.infer.assemble import (assemble_batch,
                                                     make_assembly_pool)
        from abcnet_tpu_torch.infer.decode import make_infer_pipeline
        from abcnet_tpu_torch.models.weights import load_weights

        dtype = getattr(torch, cfg["dtype"])
        model, _ = load_weights(os.path.join(harness.ROOT, cfg["weights"]),
                                device=device, dtype=dtype)
        quant = None
        if (backbone or cfg["backbone"]) == "int8":
            from abcnet_tpu_torch.infer.quant import prepare_quant
            quant = prepare_quant(model, calib)
        self.run = make_infer_pipeline(
            model, device, threshold=cfg["decode"]["binarize_threshold"],
            quant=quant)
        self.pool = make_assembly_pool(mix["processes"]) \
            if mix["processes"] > 1 else None
        self._assemble_batch = assemble_batch

    def assemble(self, peaks):
        return self._assemble_batch(peaks, pool=self.pool)

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close()
            self.pool.join()
            self.pool = None
        self.run = None


class Loop:
    """One pass of `img2smiles_loop` with the harness's spans around the
    calls into each layer: dispatch and fetch of the pipeline, assembly.
    Returns the SMILES and the pass's wall seconds."""

    def __init__(self, program: Program, keep=(), traced: bool = False):
        self.program = program
        self.keep = set(keep)
        self.kept: Dict[int, Dict] = {}
        self.traced = traced
        self.spans: Dict[str, List] = {"dispatch": [], "fetch": [],
                                       "assemble": []}

    def _span(self, name):
        if not self.traced:
            return nullcontext()
        import torch
        return torch.profiler.record_function(harness.SPAN_PREFIX + name)

    def dispatch(self, x):
        t = time.perf_counter()
        with self._span("dispatch"):
            h = self.program.run.dispatch(x)
        self.spans["dispatch"].append((t, time.perf_counter()))
        return h

    def fetch(self, h):
        t = time.perf_counter()
        with self._span("fetch"):
            out = self.program.run.fetch(h)
        self.spans["fetch"].append((t, time.perf_counter()))
        return out

    def assemble(self, peaks):
        i = len(self.spans["assemble"])
        t = time.perf_counter()
        with self._span("assemble"):
            smiles = self.program.assemble(peaks)
        self.spans["assemble"].append((t, time.perf_counter()))
        if i in self.keep:
            self.kept[i] = {"peaks": peaks, "smiles": list(smiles)}
        return smiles

    def __call__(self, images, batch: int):
        from abcnet_tpu_torch.__main__ import img2smiles_loop

        with self._span("window"):
            t0 = time.perf_counter()
            preds = img2smiles_loop(self, images, batch, None, log_every=0,
                                    assemble=self.assemble)
            t1 = time.perf_counter()
        return preds, t1 - t0



def _stamps(t0: float):
    """stamp(name): prints on standard error the seconds since the last
    stamp (the first: since the process started), a set-up phase each."""
    last = [t0]

    def stamp(name):
        now = time.perf_counter()
        print(f"setup {name} {now - last[0]:.3f} s", file=sys.stderr,
              flush=True)
        last[0] = now
    return stamp


def _order(rng, n_pool: int, n: int) -> np.ndarray:
    reps = -(-n // n_pool)
    return np.concatenate([rng.permutation(n_pool) for _ in range(reps)])[:n]


def run(ctx) -> Dict:
    """One run of a conversion cell; returns the result's parts."""
    import torch

    cfg, mix, args = ctx.cfg, ctx.mix, ctx.args
    device = ctx.device
    bsz = mix["batch"]
    harness.limit_host_threads()
    r_order, r_calib, r_sample, r_warm, r_trace = harness.seed_rngs(
        args.seed, 5)
    stamp = _stamps(ctx.t_start)
    stamp("imports")
    images = pool.load()
    n_pool = len(images)
    stamp("pool")
    calib_idx = r_calib.choice(n_pool, cfg.get("int8", {}).get(
        "calibration_images", 32), replace=False)
    calib = calibration_masks(images[calib_idx], device)
    program = ctx.make_program(cfg, mix, calib)
    stamp("program")

    # warm-up: every shape of the window, the kernels' first builds, the
    # assembly workers; then the rate that sizes the window
    warm = [images[i] for i in _order(r_warm, n_pool,
                                      bsz * (2 + mix["warm_batches"]))]
    Loop(program)(warm[:2 * bsz], bsz)
    stamp("first_batches")
    _, dt = Loop(program)(warm[2 * bsz:], bsz)
    stamp("warm_batches")
    rate = mix["warm_batches"] / dt                      # batches a second
    n_batches = max(int(round(rate * args.seconds)), 1)
    order = _order(r_order, n_pool, n_batches * bsz)
    window = [images[i] for i in order]
    sample = sorted(r_sample.choice(n_batches, min(
        mix["sample_batches"], n_batches), replace=False).tolist())
    loop = Loop(program, keep=sample)
    if device != "cpu":
        torch.cuda.synchronize(device)

    setup_s = time.perf_counter() - ctx.t_start
    host = harness.HostLoad()
    preds, wall = loop(window, bsz)
    n = len(window)
    failed = sum(s is None for s in preds) + (n - len(preds))
    out = {"attempted": n, "failed": failed, "e2e": {
        "smiles_img_per_s": n / wall, "setup_s": setup_s},
        "incomplete": len(preds) != n}
    host = host.close()
    if args.trace:
        # a second, profiled window after the timed one: the device
        # metrics read its trace, the host spans come from the whole
        # timed window
        n_tr = max(int(round(rate * min(args.seconds,
                                        mix["trace_seconds"]))), 1)
        traced = [images[i] for i in _order(r_trace, n_pool, n_tr * bsz)]
        tloop = Loop(program, traced=True)
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            tpreds, twall = tloop(traced, bsz)
        out["attempted"] += len(traced)
        out["failed"] += (sum(s is None for s in tpreds)
                          + len(traced) - len(tpreds))
        out["incomplete"] |= len(tpreds) != len(traced)
        out["obs"] = harness.Observation(
            cfg=cfg, traffic=mix, spans=loop.spans, units=n_tr,
            images=len(traced), window_s=twall,
            trace=harness.read_trace(prof))
    out["device"] = dict(harness.device_record(1), **host)

    # the window is closed: free the program, then judge what it made
    program.close()
    del program, loop.program
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    batches = [{"images": np.stack(window[i * bsz:(i + 1) * bsz]),
                **loop.kept[i]} for i in sample if i in loop.kept]
    out["numbers"] = ctx.compare(cfg, calib, batches)
    out["numbers"]["batches_compared"] = float(len(batches))
    out["sample_missing"] = len(batches) != len(sample)
    return out


def reference_weights(cfg: Dict, calib, device, bits: int = None):
    """The reference's weights from the snapshot file, and for the int8
    backbone its own quantization from the calibration masks."""
    from ..reference import unet as ref_unet

    w = ref_unet.load_snapshot(os.path.join(harness.ROOT, cfg["weights"]),
                               device)
    q = None
    if cfg["backbone"] == "int8" or bits is not None:
        q = ref_unet.prepare_int8(w, calib.permute(0, 3, 1, 2),
                                  bits or cfg["int8"]["bits"])
    return w, q


def compare(cfg: Dict, calib, batches: List[Dict], device) -> Dict:
    w, q = reference_weights(cfg, calib, device)
    return check.compare_batches(w, q, batches, check.frozen_assembler())
