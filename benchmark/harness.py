"""What every run of the benchmark shares: finding a cell's pieces by
name, the statistics, the reading of a profiler trace and the result
line.

A cell of BENCHMARK.json names a configuration and a traffic mix. The
harness finds

  * the configuration in `benchmark/configs/<config>.json` (the file the
    manifest names);
  * the traffic mix in `benchmark/traffic/<traffic>.json`, whose "kind"
    names the module `benchmark/kinds/<kind>.py` that serves it;
  * the limits of the comparison that decides `correct` in
    `benchmark/limits/<cell>.json`;
  * each per-layer metric in `benchmark/metrics/<metric>.py`, a reader
    with `read(obs) -> float or None`.

So a cell, a mix of an existing kind or a metric is added as new files
and entries in BENCHMARK.json, without an edit to a file that is there.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")
FORBIDDEN = ("jax", "jaxlib", "flax", "abcnet_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(MANIFEST)


def cell(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(man: Dict, name: str) -> Dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def limits(cell_name: str) -> Dict:
    return load_json(os.path.join(HERE, "limits", f"{cell_name}.json"))


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    """The module that serves a traffic kind."""
    return importlib.import_module(f"benchmark.kinds.{name}")


def metric_reader(name: str):
    """The reader module of a per-layer metric (its file is named after
    the metric, dots and all)."""
    return _module(os.path.join(HERE, "metrics", f"{name}.py"),
                   "benchmark.metrics." + name.replace(".", "_"))


def metrics_of(man: Dict, section: str, cell_name: str) -> List[Dict]:
    """The metrics of `section` ("end_to_end", "per_layer") this cell
    reports: those that list it, and those that list no cells."""
    return [m for m in man[section]
            if cell_name in m.get("workloads", [cell_name])]


def seed_rngs(seed: int, n: int):
    """`n` independent numpy generators from one --seed (any whole
    number; taken modulo 2^64)."""
    import numpy as np

    ss = np.random.SeedSequence(seed % 2 ** 64)
    return [np.random.default_rng(s) for s in ss.spawn(n)]


# ---------------------------------------------------------------------------
# Statistics
# ---------------------------------------------------------------------------

def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of
    the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of nothing")
    return v[max(math.ceil(q / 100.0 * len(v)) - 1, 0)]


def union_length(spans: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def gaps(spans: Sequence[Tuple[float, float]], lo: float, hi: float):
    """The idle intervals of [lo, hi) that no span covers."""
    out, cur = [], lo
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------

SPAN_PREFIX = "bench."


@dataclass
class Trace:
    """A torch.profiler window reduced to what the readers need, times
    in microseconds on the profiler's clock: every device operation
    (name, start, end), the harness's own host spans inside the window
    (name without the prefix, start, end), and the window's bounds."""
    device: List[Tuple[str, float, float]]
    spans: List[Tuple[str, float, float]]
    start: float
    end: float

    @property
    def window_us(self) -> float:
        return self.end - self.start

    @property
    def busy_us(self) -> float:
        return union_length([(s, e) for _, s, e in self.device])

    def kernel_us(self, substrings: Sequence[str]) -> float:
        """Summed time of the device operations whose name holds one of
        `substrings`."""
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in substrings))

    def top_ops(self, n: int = 10):
        by: Dict[str, float] = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        return sorted(by.items(), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10):
        """The longest intervals with no device operation, each labelled
        by the harness span that covers most of it ("none" where no span
        is open)."""
        out = []
        for s, e in gaps([(a, b) for _, a, b in self.device],
                         self.start, self.end):
            cover: Dict[str, float] = {}
            for name, a, b in self.spans:
                o = min(b, e) - max(a, s)
                if o > 0:
                    cover[name] = cover.get(name, 0.0) + o
            label = max(cover, key=cover.get) if cover else "none"
            out.append((e - s, label))
        out.sort(key=lambda t: -t[0])
        return out[:n]


def read_trace(prof) -> Trace:
    """Device operations and harness spans of a finished torch.profiler
    profile (CPU and CUDA activities)."""
    from torch.autograd import DeviceType

    device, spans, lo, hi = [], [], math.inf, -math.inf
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN_PREFIX):
            # a host span, which the profiler also mirrors on the device's
            # timeline as an annotation: no device operation
            if e.device_type == DeviceType.CUDA:
                continue
            if e.name == SPAN_PREFIX + "window":
                lo, hi = s, t
            else:
                spans.append((e.name[len(SPAN_PREFIX):], s, t))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, s, t))
    if not math.isfinite(lo):
        raise RuntimeError("the trace holds no window span")
    return Trace(device, spans, lo, hi)


# ---------------------------------------------------------------------------
# What a run observed, for the per-layer readers
# ---------------------------------------------------------------------------

@dataclass
class Observation:
    """What a traced run hands every per-layer reader: the configuration
    and mix, the host spans in seconds by name, the units of work the
    traced window did (batches or steps) and the images in them, its
    length in seconds, and the trace."""
    cfg: Dict
    traffic: Dict
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    units: int = 0
    images: int = 0
    window_s: float = 0.0
    trace: Optional[Trace] = None


# ---------------------------------------------------------------------------
# Device, guard, result line
# ---------------------------------------------------------------------------

def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device (torch.cuda.is_available() "
                         "is false); the benchmark never falls back to the "
                         "CPU")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"error: the cell needs {n} CUDA devices, "
                         f"{torch.cuda.device_count()} found")


def power_limit_w() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None


def device_record(count: int) -> Dict:
    import torch

    on_card = torch.cuda.is_available()
    return {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": count,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                 for i in range(count)) if on_card else 0,
        "power_limit_w": power_limit_w() if on_card else None,
    }


HOST_THREADS = 1


def limit_host_threads() -> None:
    """Run the host side of a run on few threads: torch's intra-op pool
    to HOST_THREADS (its workers otherwise take as many cores as the
    host has, against the loop's own threads on a shared host)."""
    import torch

    torch.set_num_threads(HOST_THREADS)


def _cpu_times():
    """(busy, steal, total) jiffies of all CPUs from /proc/stat, or None."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    idle = v[3] + (v[4] if len(v) > 4 else 0)
    steal = v[7] if len(v) > 7 else 0
    total = sum(v[:8])
    return total - idle - steal, steal, total


def contended_procs() -> int:
    """Other python processes using more than 20% of a CPU (as `ps`
    reports it)."""
    me = os.getpid()
    try:
        out = subprocess.run(["ps", "-eo", "pid,pcpu,comm"],
                             capture_output=True, text=True,
                             timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    n = 0
    for line in out.splitlines()[1:]:
        parts = line.split()
        if len(parts) >= 3 and "python" in parts[2]:
            try:
                if int(parts[0]) != me and float(parts[1]) > 20.0:
                    n += 1
            except ValueError:
                pass
    return n


class HostLoad:
    """What else loaded the host over a window: opened at its start,
    `close()` at its end gives the record's host keys: the host's CPUs
    and those this process may run on, the threads of torch's intra-op
    pool, the 1-minute load average, the share of the host's CPU time
    that was busy and that the hypervisor stole over the window, and the
    other busy python processes."""

    def __init__(self):
        self.t0 = _cpu_times()

    def close(self) -> Dict:
        import torch

        t1 = _cpu_times()
        rec = {"host_cpus": os.cpu_count(),
               "affinity_cpus": len(os.sched_getaffinity(0)),
               "host_threads": torch.get_num_threads(),
               "load_avg_1m": os.getloadavg()[0],
               "contended_procs": contended_procs()}
        if self.t0 and t1 and t1[2] > self.t0[2]:
            span = t1[2] - self.t0[2]
            rec["host_busy_pct"] = 100.0 * (t1[0] - self.t0[0]) / span
            rec["host_steal_pct"] = 100.0 * (t1[1] - self.t0[1]) / span
        return rec


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that this process must not
    hold, compared whole (abcnet_tpu_torch is not abcnet_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def emit(result: Dict, checks: Dict[str, Dict]) -> None:
    """Each number compared beside its limit, as the last lines on
    standard error, then the result as the last line on standard output,
    with the checks under their own key last."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
