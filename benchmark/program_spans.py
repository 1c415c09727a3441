"""The program's own spans and counters for the per-layer readers.

The conversion loop records them (abcnet_tpu_torch/utils/profiling.py)
only while a torch.profiler profile is active on its thread, so after a
--trace 1 run the recorder holds the profiled window's batches alone.
Its times come from time.perf_counter_ns(); the harness's `Trace` holds
microseconds from the profiler's start, and keeps none of the program's
ranges. `offset_us` joins the two clocks: the harness's `dispatch` span
wraps the call into the pipeline's `dispatch`, which the program times
as its own `dispatch` span, so the median offset between the two over
the same batches carries the program's spans onto the trace, and a
sound join puts each program span inside its harness span.

Every function returns None where there is nothing to read: a program
without the recorder (an older checkout), a run that recorded nothing,
or a join that does not hold.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Sequence, Tuple

from benchmark import harness

TOLERANCE_US = 100.0      # how far a joined span may leave its harness span
MISALIGNED_SHARE = 0.05   # the share of joined spans that may leave it


def recorded():
    """(spans, counters) the program recorded, or None."""
    try:
        from abcnet_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "spans"):
        return None
    spans = profiling.spans()
    if not spans:
        return None
    return spans, profiling.counters()


def mean_ms(name: str) -> Optional[float]:
    """Milliseconds a batch in the program's spans `name`: the summed
    length over the batches that have one."""
    got = recorded()
    if got is None:
        return None
    by: Dict[int, int] = {}
    for s in got[0]:
        if s.name == name:
            by[s.batch] = by.get(s.batch, 0) + s.end_ns - s.start_ns
    if not by:
        return None
    return sum(by.values()) / len(by) / 1e6


def offset_us(spans: Sequence, trace) -> Optional[float]:
    """Microseconds to add to a program time (perf_counter_ns / 1e3) to
    place it on the trace: the median of the starts' offsets between the
    program's `dispatch` spans and the harness's, paired in order. None
    where their counts differ or more than MISALIGNED_SHARE of the
    joined spans leave their harness span by more than TOLERANCE_US."""
    prog = sorted((s for s in spans if s.name == "dispatch"),
                  key=lambda s: s.start_ns)
    harn = sorted((a, b) for n, a, b in trace.spans if n == "dispatch")
    if not prog or len(prog) != len(harn):
        return None
    off = statistics.median(a - s.start_ns / 1e3
                            for s, (a, _) in zip(prog, harn))
    bad = sum(max(a - (s.start_ns / 1e3 + off),
                  s.end_ns / 1e3 + off - b) > TOLERANCE_US
              for s, (a, b) in zip(prog, harn))
    if bad > MISALIGNED_SHARE * len(prog):
        return None
    return off


def overlap(a: Sequence[Tuple[float, float]],
            b: Sequence[Tuple[float, float]]) -> float:
    """Length of the intersection of two unions of intervals."""
    return (harness.union_length(a) + harness.union_length(b)
            - harness.union_length(list(a) + list(b)))


def device_idle_share(trace, names: Sequence[str]) -> Optional[float]:
    """Percent of the traced window's device-idle time in which one of
    the program's spans `names` was open, the spans joined onto the
    trace by `offset_us`."""
    got = recorded()
    if got is None or trace is None or not trace.device:
        return None
    spans = got[0]
    off = offset_us(spans, trace)
    if off is None:
        return None
    idle = harness.gaps([(s, e) for _, s, e in trace.device], trace.start,
                        trace.end)
    total = sum(e - s for s, e in idle)
    if not total:
        return None
    open_ = [(s.start_ns / 1e3 + off, s.end_ns / 1e3 + off)
             for s in spans if s.name in names]
    return 100.0 * overlap(idle, open_) / total
