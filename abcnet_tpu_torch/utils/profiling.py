"""Tracing helpers, counterpart of abcnet_tpu/utils/profiling.py:

  * `trace(dir)`: a context manager around torch.profiler that writes a
    chrome trace (the device timeline of CPU ops and CUDA kernels) to
    `dir/trace.json`, the serving loop's spans and counters of the same
    window to `dir/spans.json`, and returns the profiler for
    `key_averages()`;
  * the span recorder: `span(name)` times a stretch of the serving loop,
    `count(name, n)` adds to a counter, both filed under the batch they
    work on. `img2smiles_loop` opens one batch at a time with
    `start_batch()`, which hands out a batch id only while a
    torch.profiler profile is active on the loop's thread; without one
    every span and counter is a no-op. `in_batch(bid, fn)` carries the
    batch over to the loop's worker thread, where torch.profiler records
    nothing of its own. `spans()`, `counters()` and `clear()` read and
    empty what was recorded (bounded: the oldest go first).

The spans of a batch, in the order the loop runs them (the loop's
thread unless named):

  stack     the batch's drawings stacked into one array, the last chunk
            padded
  dispatch  the pipeline's asynchronous half, parent of
    pack      binarize and bit-pack on the host, pin
    enqueue   the copy to the device, the device program's launches,
              the copies of the peak buffers back
  fetch     (worker thread) parent of
    d2h_wait  waiting for the device and the copies
    unpack    the host peak dict from the copied buffers
  assemble  (worker thread, after the fetch) host assembly of the
            batch's SMILES
  wait      the loop waiting for the worker's fetch and assembly of the
            batch, once two later batches are dispatched

and inside `enqueue`, for the CBAM U-Net (models/unet_cbam.py), one
`cbam` span around each of its 13 gate sites (channel gate, spatial
gate, residual add, ReLU), and for the DLA-34 + DCN model
(models/dla_dcn.py) one `dcn` span around each of its 16 deformable
sites (offset / mask conv, sampling, contraction, BatchNorm, ReLU).

Its counters: `images` (rows assembled), `atoms` and `bonds` (valid
peaks handed to assembly), `smiles_none` (rows with no SMILES), on the
serial native assembly path `graph_ns` and `smiles_ns` (the summed
native time of graph assembly and of SMILES writing), on the loop's
thread `assembly_ready` (1 where the worker was done with the batch when
the loop asked for it), and for the CBAM U-Net `cbam_gates` (gate sites
run), `cbam_fused` (those that ran the gate's kernels,
ops/cbam_gate.py) and `cbam_device_us` (their device time), and for
the DLA-34 + DCN model `dcn_sites` (deformable sites run) and
`dcn_device_us` (their device time).

A device span (`device_span`) is a span that also times the device work
it enqueues: two CUDA events on the current stream, recorded only while
the thread records; `resolve_device_spans`, called where the batch's
device work is known to be done (the pipeline's fetch, after its
copies' event), adds their elapsed time to the counter
`<name>_device_us`. While a profile is active, each span of the loop's
thread is also an `abcnet.<name>` range of the chrome trace, beside the
kernels it launched, and never a device event.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
from collections import OrderedDict, deque
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

MAX_SPANS = 1 << 16
MAX_BATCHES = 1 << 12
PREFIX = "abcnet."

# A host range of the chrome trace that is not also drawn on the device
# timeline: torch.profiler.record_function's ranges are mirrored there
# over the kernels they launched, and would read as device work.
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


@contextlib.contextmanager
def trace(log_dir: str):
    """with trace('/tmp/trace') as prof: ...steps... -> log_dir/trace.json
    (chrome://tracing or Perfetto) and log_dir/spans.json (the serving
    loop's spans and counters of the window, `write_spans`). CUDA
    activity is traced when a GPU is present."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    clear()
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    write_spans(os.path.join(log_dir, "spans.json"), chrome_base_ns(path),
                prof.profiler.kineto_results.trace_start_ns())


class Span(NamedTuple):
    """One timed stretch: times from time.perf_counter_ns(), the thread's
    native id (the chrome trace's tid), the enclosing span's name on the
    same thread, the batch id."""
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: Optional[str]
    batch: int


class Recorder:
    """Spans and per-batch counters, bounded, safe across threads. The
    first batch id handed out after a clear also takes the pair
    (perf_counter_ns, time_ns) that places spans on the Unix clock."""

    def __init__(self, max_spans: int = MAX_SPANS,
                 max_batches: int = MAX_BATCHES):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=max_spans)
        self._counters: OrderedDict = OrderedDict()
        self._events: OrderedDict = OrderedDict()
        self._max_batches = max_batches
        self._next = 0
        self.anchor = None

    def new_batch(self) -> int:
        with self._lock:
            if self.anchor is None:
                self.anchor = (time.perf_counter_ns(), time.time_ns())
            self._next += 1
            return self._next - 1

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def count(self, batch: int, name: str, n: int) -> None:
        with self._lock:
            c = self._counters.get(batch)
            if c is None:
                c = self._counters[batch] = {}
                while len(self._counters) > self._max_batches:
                    self._counters.popitem(last=False)
            c[name] = c.get(name, 0) + n

    def add_events(self, batch: int, name: str, start, end) -> None:
        """A device span's pair of CUDA events, kept until the batch's
        `take_events`."""
        with self._lock:
            ev = self._events.get(batch)
            if ev is None:
                ev = self._events[batch] = []
                while len(self._events) > self._max_batches:
                    self._events.popitem(last=False)
            ev.append((name, start, end))

    def take_events(self, batch: int) -> List:
        with self._lock:
            return self._events.pop(batch, [])

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def counters(self) -> Dict[int, Dict[str, int]]:
        with self._lock:
            return {b: dict(c) for b, c in self._counters.items()}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._events.clear()
            self._next = 0
            self.anchor = None


RECORDER = Recorder()


class _Thread(threading.local):
    batch: Optional[int] = None        # None: this thread records nothing

    def __init__(self):
        self.open: List[str] = []      # open spans' names, innermost last


_THREAD = _Thread()
_OFF = contextlib.nullcontext()


def start_batch() -> Optional[int]:
    """A new batch id while a torch.profiler profile is active on this
    thread, else None: the serving loop's one check a batch."""
    if not torch.autograd._profiler_enabled():
        return None
    return RECORDER.new_batch()


class batch:
    """`with batch(bid):` files this thread's spans and counters under
    batch `bid`; with None they are no-ops. Restores the outer batch."""
    __slots__ = ("bid", "outer")

    def __init__(self, bid: Optional[int]):
        self.bid = bid

    def __enter__(self):
        self.outer = _THREAD.batch
        _THREAD.batch = self.bid
        return self

    def __exit__(self, *exc):
        _THREAD.batch = self.outer
        return False


def in_batch(bid: Optional[int], fn: Callable) -> Callable:
    """`fn`, to be called on another thread as part of batch `bid`."""
    if bid is None:
        return fn

    def run(*args, **kwargs):
        with batch(bid):
            return fn(*args, **kwargs)
    return run


def recording() -> bool:
    """Whether this thread's spans and counters are recorded now."""
    return _THREAD.batch is not None


class _Span:
    __slots__ = ("name", "bid", "parent", "range", "start")

    def __init__(self, name: str, bid: int):
        self.name, self.bid = name, bid

    def __enter__(self):
        opened = _THREAD.open
        self.parent = opened[-1] if opened else None
        opened.append(self.name)
        self.range = None
        if _RANGE is not None and torch.autograd._profiler_enabled():
            self.range = _RANGE(PREFIX + self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _THREAD.open.pop()
        RECORDER.add(Span(self.name, self.start, end,
                          threading.get_native_id(), self.parent, self.bid))
        return False


class _DeviceSpan(_Span):
    __slots__ = ("events",)

    def __init__(self, name: str, bid: int, device: torch.device):
        super().__init__(name, bid)
        stream = torch.cuda.current_stream(device)
        self.events = (stream, torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        super().__enter__()
        stream, start, _ = self.events
        start.record(stream)
        return self

    def __exit__(self, *exc):
        stream, start, end = self.events
        end.record(stream)
        RECORDER.add_events(self.bid, self.name, start, end)
        return super().__exit__(*exc)


def span(name: str):
    """Context manager timing `name` in this thread's batch (a no-op
    where the thread records nothing)."""
    bid = _THREAD.batch
    return _OFF if bid is None else _Span(name, bid)


def device_span(name: str, x: torch.Tensor):
    """`span(name)` that, for a CUDA tensor `x`, also times the device
    work enqueued inside it on x's device's current stream: a CUDA event
    at each end, read by `resolve_device_spans`. A no-op where the
    thread records nothing; on the CPU a plain span."""
    bid = _THREAD.batch
    if bid is None:
        return _OFF
    if x.device.type != "cuda":
        return _Span(name, bid)
    return _DeviceSpan(name, bid, x.device)


def resolve_device_spans() -> None:
    """Add the device time of this thread's batch's device spans to the
    counters `<name>_device_us` (microseconds, summed by name). Call it
    once the batch's device work has finished: an event's elapsed time
    is read, never waited for."""
    bid = _THREAD.batch
    if bid is None:
        return
    ms: Dict[str, float] = {}
    for name, start, end in RECORDER.take_events(bid):
        ms[name] = ms.get(name, 0.0) + start.elapsed_time(end)
    for name, v in ms.items():
        RECORDER.count(bid, f"{name}_device_us", round(v * 1e3))


def count(name: str, n: int) -> None:
    """Add `n` to counter `name` of this thread's batch."""
    bid = _THREAD.batch
    if bid is not None:
        RECORDER.count(bid, name, int(n))


def spans() -> List[Span]:
    return RECORDER.spans()


def counters() -> Dict[int, Dict[str, int]]:
    return RECORDER.counters()


def clear() -> None:
    RECORDER.clear()


def chrome_base_ns(path: str) -> int:
    """The `baseTimeNanoseconds` of a chrome trace torch.profiler
    exported (its `ts` are microseconds from it; 0 where absent), read
    from the file's head."""
    with open(path, "rb") as f:
        m = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', f.read(1 << 14))
    return int(m.group(1)) if m else 0


def write_spans(path: str, base_ns: int, trace_start_ns: int) -> None:
    """The recorder's spans as complete ("X") events of a chrome trace on
    the clock of the profile's trace.json (microseconds from `base_ns`),
    so their `traceEvents` merge with that file's; each event's args give
    its batch, its parent and its start in microseconds from the
    profile's start (`trace_start_ns`, the clock of `prof.events()`).
    Beside them, the counters by batch."""
    recorded, anchor = spans(), RECORDER.anchor
    events = []
    if anchor is not None:
        shift = anchor[1] - anchor[0]          # perf_counter_ns -> Unix ns
        pid = os.getpid()
        for s in recorded:
            unix = s.start_ns + shift
            events.append({
                "ph": "X", "cat": "abcnet", "name": PREFIX + s.name,
                "pid": pid, "tid": s.thread,
                "ts": (unix - base_ns) / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {"batch": s.batch, "parent": s.parent,
                         "from_trace_start_us":
                             (unix - trace_start_ns) / 1e3}})
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base_ns,
                   "trace_start_ns": trace_start_ns,
                   "traceEvents": events,
                   "counters": {str(b): c
                                for b, c in counters().items()}}, f)

