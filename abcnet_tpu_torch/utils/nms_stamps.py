"""Where the NMS/top-K kernel's time goes: clock64() stamps per stage.

    python -m abcnet_tpu_torch.utils.nms_stamps        # one NVIDIA GPU

Builds `csrc/nms_topk.cu` a second time with -DABCNET_NMS_STAMPS (a
timing-only build: thread 0 of every CTA keeps clock64() at eight places
and %globaltimer at entry and exit), runs both heatmaps of a batch of 64
through it at every cluster size, and prints one JSON line per cluster
size:

  * `span_ns`: first CTA's entry to last CTA's exit, on %globaltimer;
  * `first_cta_ns`: entry to exit of a cluster's first CTA, the median
    over all clusters;
  * `stage_cycles`: the medians, over all first CTAs, of the SM cycles
    between two stamps: `nms` (entry to the survivor bitmask), `keys`
    (bitmask to keys), `sort_or_skip` (the sort a band with more than K
    survivors makes; else a jump over it), `hand_over` (wait for the
    cluster, place and write the keys, the cluster barrier, and under it
    the list of non-survivors), `sync`, `merge` (slots by counting),
    `exhausted` (the -inf slots);
  * `code_bytes`: the size of each kernel's SASS (cuobjdump), because the
    stages' times follow the instructions that run once, not the work.

The maps are made from a seed to look like a trained model's heatmaps: a
background well below the threshold and about 30 isolated peaks a map
(`--peaks`), so that they take the path a serving batch takes; `--dense`
makes random logits instead, which take the sorting route. The stamps
cost time themselves; the kernel's own time is `kernel_times` in
chip_smoke.py.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

from . import build

STAGES = ("nms", "keys", "sort_or_skip", "hand_over", "sync", "merge",
          "exhausted")


def build_stamped() -> str:
    """nvcc of csrc/nms_topk.cu with the stamps compiled in."""
    cmd, srcs = build._job("nms_topk")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    path = os.path.join(build.BUILD_DIR, "nms_topk_stamps.so")
    subprocess.run([*cmd, "-DABCNET_NMS_STAMPS", "-o", path, *srcs],
                   check=True, capture_output=True, text=True)
    return path


def code_bytes(path: str) -> dict:
    """{kernel name: bytes of SASS} of a built library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    sizes, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = re.sub(r"^.*_cu_[0-9a-f]+", "",
                          line.split(":", 1)[1].strip())
        m = re.match(r"\s+/\*([0-9a-f]{4,6})\*/", line)
        if m and name:
            sizes[name] = int(m.group(1), 16) + 16
    return sizes


def trained_like_maps(b: int, peaks: int, seed: int, device) -> torch.Tensor:
    """(b, 128, 128) bf16: background about -8, `peaks` cells of 1..7."""
    gen = torch.Generator().manual_seed(seed)
    maps = torch.randn(b, 128, 128, generator=gen) * 0.5 - 8
    for i in range(b):
        rows = torch.randint(2, 126, (peaks,), generator=gen)
        cols = torch.randint(2, 126, (peaks,), generator=gen)
        maps[i, rows, cols] = torch.rand(peaks, generator=gen) * 6 + 1
    return maps.to(device, torch.bfloat16)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--peaks", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dense", action="store_true",
                    help="random logits instead: about 450 survivors a band, "
                         "the sorting route")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("nms_stamps: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from ..ops.peaks import nms_topk_plain

    path = build_stamped()
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.abcnet_nms_topk.argtypes = [p, i, p, p, p, i, p, p, i, i, i, i,
                                    ctypes.c_float, i, i, p]
    lib.abcnet_nms_topk.restype = i
    lib.abcnet_nms_topk_stamps.argtypes = [p]
    lib.abcnet_nms_topk_stamps.restype = None

    dev = torch.device("cuda")
    b = args.batch
    if args.dense:
        gen = torch.Generator().manual_seed(args.seed)
        a_map, b_map = ((torch.randn(b, 128, 128, generator=gen) * 3)
                        .to(dev, torch.bfloat16) for _ in range(2))
    else:
        a_map = trained_like_maps(b, args.peaks, args.seed, dev)
        b_map = trained_like_maps(b, args.peaks + 2, args.seed + 1, dev)
    out = [torch.empty(b, k, dtype=dt, device=dev)
           for k in (128, 160) for dt in (torch.float32, torch.int32)]

    def run(cluster):
        err = lib.abcnet_nms_topk(
            a_map.data_ptr(), 128, out[0].data_ptr(), out[1].data_ptr(),
            b_map.data_ptr(), 160, out[2].data_ptr(), out[3].data_ptr(),
            2, b, 128, 128, -1.0, 1, cluster,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed (CUDA error {err})")

    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "batch": b,
                      "maps": "dense" if args.dense else f"{args.peaks} peaks",
                      "code_bytes": code_bytes(path)}), flush=True)
    for cluster in (1, 2, 4, 8):
        n_cta = cluster * b * 2
        stamps = torch.zeros(n_cta * 16, dtype=torch.int64, device=dev)
        lib.abcnet_nms_topk_stamps(stamps.data_ptr())
        for _ in range(3):
            run(cluster)
        torch.cuda.synchronize()
        stamps.zero_()
        torch.cuda._sleep(4_000_000)      # the launch is not what is timed
        run(cluster)
        torch.cuda.synchronize()
        lib.abcnet_nms_topk_stamps(None)
        for (s, i_), k, m in ((out[:2], 128, a_map), (out[2:], 160, b_map)):
            ps, pi = nms_topk_plain(m, k, -1.0)
            if not (torch.equal(s, ps) and torch.equal(i_, pi)):
                raise AssertionError("the stamped kernel disagrees with the "
                                     "plain version")
        t = stamps.cpu().numpy().reshape(n_cta, 16)
        first = t[::cluster]              # rank 0 of every cluster
        if cluster == 1:                  # no hand-over: stamp 4 is not set
            first = first.copy()
            first[:, 4] = first[:, 3]
        stage = np.median(np.diff(first[:, :8], axis=1), axis=0)
        print(json.dumps({
            "cluster": cluster, "ctas": n_cta,
            "span_ns": int(t[:, 9].max() - t[:, 8].min()),
            "first_cta_ns": float(np.median(first[:, 9] - first[:, 8])),
            "first_cta_cycles": float(np.median(first[:, 7] - first[:, 0])),
            "stage_cycles": dict(zip(STAGES, stage.tolist()))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
