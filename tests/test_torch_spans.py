"""The conversion loop's spans and counters (utils/profiling.py) on the
CPU: nothing is recorded without a profiler; under one every span of a
batch is recorded once, with its parent, thread and batch id, the
worker thread's fetch and assembly too, and the counters hold the peaks
handed to assembly and whether the loop found each batch assembled;
`trace` writes them beside the chrome trace on its clock; the recorder
under threads; and the benchmark's readers of them
(benchmark/program_spans.py, benchmark/metrics/): the clock join finds a
planted offset and refuses misaligned spans, each reader reads nothing
from an empty recorder, and a --trace 1 run of a cell on the CPU reads
the program's spans."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from abcnet_tpu_torch import __main__ as cli
from abcnet_tpu_torch.infer.assemble import assemble_batch
from abcnet_tpu_torch.infer.decode import make_infer_pipeline
from abcnet_tpu_torch.infer.native import load_native
from abcnet_tpu_torch.models.weights import load_weights
from abcnet_tpu_torch.utils import profiling
from torch_parity import FIXTURE, REPO, SNAPSHOT

sys.path.insert(0, REPO)

from benchmark import harness, program_spans  # noqa: E402

LOOP = ("stack", "dispatch", "pack", "enqueue", "wait")
FETCH = ("fetch", "d2h_wait", "unpack", "assemble")
PARENT = {"pack": "dispatch", "enqueue": "dispatch", "d2h_wait": "fetch",
          "unpack": "fetch"}
READERS = ("pack_ms", "enqueue_ms", "loop_wait_ms", "assemble_us_per_peak",
           "device_idle_assemble_pct", "device_idle_enqueue_pct")
BATCH, N_IMAGES = 2, 5                 # three batches, the last one padded


@pytest.fixture(scope="module")
def run():
    model, _ = load_weights(SNAPSHOT, device="cpu", dtype=torch.float32)
    return make_infer_pipeline(model, "cpu")


@pytest.fixture(scope="module")
def images():
    """Centre crops (128²) of fixture drawings."""
    z = np.load(FIXTURE)["images"]
    return [np.ascontiguousarray(z[r, 192:320, 192:320])
            for r in (0, 1, 40, 41, 3)]


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def loop(run, images, handed=None):
    """img2smiles_loop with the default assembly; `handed` collects the
    peak dicts assembly is handed, in order."""
    def assemble(peaks):
        if handed is not None:
            handed.append(peaks)
        return assemble_batch(peaks)
    return cli.img2smiles_loop(run, images, BATCH, log_every=0,
                               assemble=assemble)


def test_no_profiler_records_nothing(run, images):
    preds = loop(run, images)
    assert len(preds) == N_IMAGES
    assert profiling.spans() == [] and profiling.counters() == {}
    assert profiling.RECORDER.anchor is None


def test_profiled_loop_records_every_span_once_a_batch(run, images):
    want = loop(run, images)
    handed = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = loop(run, images, handed)
    assert got == want
    spans, counters = profiling.spans(), profiling.counters()
    main = threading.get_native_id()
    batches = range(len(handed))
    assert len(handed) == 3
    for name in LOOP + FETCH:
        mine = [s for s in spans if s.name == name]
        assert sorted(s.batch for s in mine) == list(batches), name
        for s in mine:
            assert s.parent == PARENT.get(name), name
            assert (s.thread == main) == (name in LOOP), name
            assert s.end_ns >= s.start_ns
    by = {(s.name, s.batch): s for s in spans}
    for b in batches:
        for child, parent in PARENT.items():
            c, p = by[child, b], by[parent, b]
            assert p.start_ns <= c.start_ns <= c.end_ns <= p.end_ns
        assert by["stack", b].end_ns <= by["dispatch", b].start_ns
        assert by["dispatch", b].end_ns <= by["fetch", b].start_ns
        # the worker assembles the batch it fetched; the loop's wait
        # ends once that assembly has
        assert by["fetch", b].end_ns <= by["assemble", b].start_ns
        assert by["assemble", b].end_ns <= by["wait", b].end_ns
    for b, peaks in enumerate(handed):
        c = counters[b]
        assert c["atoms"] == int(peaks["atom_valid"].sum())
        assert c["bonds"] == int(peaks["bond_valid"].sum())
        assert c["images"] == BATCH
        assert c["assembly_ready"] in (0, 1)
        assert c["smiles_none"] == sum(
            s is None for s in assemble_batch(peaks))
        if load_native() is not None:
            assert c["graph_ns"] > 0 and c["smiles_ns"] > 0
    assert sum(c["atoms"] for c in counters.values()) > 0
    # the loop's thread's spans are ranges of the profile too, the worker
    # thread's are not (the profiler records nothing of that thread)
    ranges = {}
    for e in prof.events():
        if e.name.startswith(profiling.PREFIX):
            key = e.name[len(profiling.PREFIX):]
            ranges[key] = ranges.get(key, 0) + 1
    assert ranges == {name: 3 for name in LOOP}


class _SlowPipeline:
    """dispatch -> first pixel of each image, a pause on batch `slow`;
    fetch on the worker thread."""

    def __init__(self, slow):
        self.slow, self.n = slow, 0

    def dispatch(self, batch):
        if self.n == self.slow:
            time.sleep(0.3)
        self.n += 1
        return batch[:, 0, 0].copy()

    def fetch(self, handle):
        return handle


def test_assembly_ready_counts_each_batch_once():
    """1 where the worker had assembled the batch before the loop asked
    for it (batch 0: the loop dispatched two more, one slowly), 0 where
    it had not (the last batch, whose assembly takes 0.3 s)."""
    def assemble(peaks):
        if peaks[0] == 3:
            time.sleep(0.3)
        return [str(v) for v in peaks]

    images = [np.full((4, 4), i // 2, np.uint8) for i in range(8)]
    with profile(activities=[ProfilerActivity.CPU]):
        preds = cli.img2smiles_loop(_SlowPipeline(slow=2), images, 2,
                                    log_every=0, assemble=assemble)
    assert preds == [str(i // 2) for i in range(8)]
    counters = profiling.counters()
    assert sorted(counters) == [0, 1, 2, 3]
    assert all(c["assembly_ready"] in (0, 1) for c in counters.values())
    assert counters[0]["assembly_ready"] == 1
    assert counters[3]["assembly_ready"] == 0
    waits = [s for s in profiling.spans() if s.name == "wait"]
    assert sorted(s.batch for s in waits) == [0, 1, 2, 3]
    assert all(s.thread == threading.get_native_id() for s in waits)


def test_trace_writes_the_spans_on_the_chrome_trace_clock(run, images,
                                                          tmp_path):
    with profiling.trace(str(tmp_path)):
        loop(run, images)
    with open(tmp_path / "trace.json") as f:
        chrome = json.load(f)
    with open(tmp_path / "spans.json") as f:
        written = json.load(f)
    assert written["baseTimeNanoseconds"] == chrome["baseTimeNanoseconds"]
    ours = {(e["name"], e["args"]["batch"]): e
            for e in written["traceEvents"]}
    assert len(ours) == 3 * len(LOOP + FETCH)
    assert {int(b) for b in written["counters"]} == {0, 1, 2}
    theirs = sorted((e["ts"], e["dur"]) for e in chrome["traceEvents"]
                    if e.get("name") == profiling.PREFIX + "dispatch")
    mine = sorted((e["ts"], e["dur"], e["tid"]) for k, e in ours.items()
                  if k[0] == profiling.PREFIX + "dispatch")
    assert len(theirs) == len(mine) == 3
    for (ts, dur), (ts2, dur2, tid) in zip(theirs, mine):
        # the Unix clock against the profiler's: within a millisecond
        assert abs(ts - ts2) < 1e3 and abs(dur - dur2) < 1e3
        assert tid == threading.get_native_id()
    fetch = [e for e in written["traceEvents"]
             if e["name"] == profiling.PREFIX + "fetch"]
    assert all(e["tid"] != threading.get_native_id() for e in fetch)


def test_spans_off_and_nested_batches():
    with profiling.span("stack"):
        profiling.count("atoms", 3)
    assert not profiling.recording()
    with profiling.batch(7):
        assert profiling.recording()
        with profiling.batch(None):
            with profiling.span("wait"):
                pass
            assert not profiling.recording()
        with profiling.span("assemble"):
            profiling.count("atoms", 3)
    assert not profiling.recording()
    assert [(s.name, s.batch) for s in profiling.spans()] == [
        ("assemble", 7)]
    assert profiling.counters() == {7: {"atoms": 3}}


def test_recorder_is_bounded():
    rec = profiling.Recorder(max_spans=4, max_batches=2)
    for b in range(5):
        rec.add(profiling.Span("x", b, b + 1, 0, None, b))
        rec.count(b, "n", 1)
    assert [s.batch for s in rec.spans()] == [1, 2, 3, 4]
    assert rec.counters() == {3: {"n": 1}, 4: {"n": 1}}


def test_recorder_loses_nothing_across_threads():
    n_threads, n_each = 16, 400
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with profiling.batch(0):
                for _ in range(n_each):
                    with profiling.span("unpack"):
                        profiling.count("atoms", 1)
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert len(profiling.spans()) == n_threads * n_each
    assert profiling.counters() == {0: {"atoms": n_threads * n_each}}


# ---------------------------------------------------------------------------
# The benchmark's readers
# ---------------------------------------------------------------------------

def planted(offset_us, jitter_us=(), n=40):
    """Program spans and a harness trace of `n` batches: each harness
    dispatch span wraps the program's by 5 µs a side, the program clock
    `offset_us` behind the trace's (`jitter_us[i]` more for batch i);
    the device busy for the first 10 ms of each 50-ms batch, then idle
    through the program's 30-ms assembly."""
    spans, device, harn = [], [], []
    for i in range(n):
        t = 1_000_000 + 50_000 * i                # trace µs
        p = t - offset_us - (jitter_us[i] if i < len(jitter_us) else 0)
        spans += [profiling.Span("dispatch", int(p * 1e3),
                                 int((p + 8_000) * 1e3), 1, None, i),
                  profiling.Span("enqueue", int((p + 2_000) * 1e3),
                                 int((p + 8_000) * 1e3), 1, "dispatch", i),
                  profiling.Span("assemble", int((p + 15_000) * 1e3),
                                 int((p + 45_000) * 1e3), 1, None, i)]
        harn.append(("dispatch", t - 5, t + 8_005))
        device.append(("kernel", t + 2_000, t + 12_000))
    trace = harness.Trace(device, harn, 1_000_000, 1_000_000 + 50_000 * n)
    return spans, trace


def fill(spans, counters=None):
    for s in spans:
        profiling.RECORDER.add(s)
    for b, c in (counters or {}).items():
        for k, v in c.items():
            profiling.RECORDER.count(b, k, v)


@pytest.mark.parametrize("offset_us", [0.0, 1.7e9, -3.25e12])
def test_clock_join_recovers_a_planted_offset(offset_us):
    spans, trace = planted(offset_us)
    # the harness's span opens 5 µs before the program's
    assert abs(program_spans.offset_us(spans, trace) - (offset_us - 5)) \
        < 1e-3


def test_clock_join_refuses_misaligned_spans():
    spans, trace = planted(5e8, jitter_us=[0] * 37 + [500, 500, 500])
    assert program_spans.offset_us(spans, trace) is None   # 3 of 40 > 5%
    spans, trace = planted(5e8, jitter_us=[0] * 38 + [500, 500])
    assert abs(program_spans.offset_us(spans, trace) - (5e8 - 5)) < 1e-3
    spans, trace = planted(5e8)
    assert program_spans.offset_us(spans[3:], trace) is None  # a batch less


def test_readers_on_planted_spans():
    spans, trace = planted(2.5e9)
    fill(spans, {i: {"atoms": 20, "bonds": 30} for i in range(40)})
    obs = harness.Observation(cfg={}, traffic={}, trace=trace)
    read = {m: harness.metric_reader(m).read(obs) for m in READERS}
    assert read["pack_ms"] is None and read["loop_wait_ms"] is None
    assert read["enqueue_ms"] == pytest.approx(6.0)
    assert read["assemble_us_per_peak"] == pytest.approx(30_000 / 50)
    # idle 40 ms a batch (the last batch's to the window's end too), of
    # which assembly covers 30 and the launches (busy) none but the 5 µs
    # by which the join places them early
    assert read["device_idle_assemble_pct"] == pytest.approx(75.0)
    assert read["device_idle_enqueue_pct"] == pytest.approx(100 * 5 / 40e3)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_from_an_empty_recorder(name):
    _, trace = planted(0.0)
    obs = harness.Observation(cfg={}, traffic={}, trace=trace)
    assert harness.metric_reader(name).read(obs) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_from_a_program_without_spans(name,
                                                            monkeypatch):
    spans, trace = planted(0.0)
    fill(spans)
    monkeypatch.delattr(profiling, "spans")
    obs = harness.Observation(cfg={}, traffic={}, trace=trace)
    assert harness.metric_reader(name).read(obs) is None


def test_traced_cpu_run_reads_the_program_spans(monkeypatch):
    # the run puts benchmark/ first on sys.path (whose `tests` package
    # would then shadow this directory's) and drops torch to the harness's
    # one thread: both are undone after the test, for the tests that the
    # same worker runs next
    monkeypatch.setattr(sys, "path", list(sys.path))
    sys.path.insert(0, os.path.join(REPO, "benchmark"))
    from benchmark.tests.cpu_run import cpu_context, cpu_run

    threads = torch.get_num_threads()
    try:
        line, checks = cpu_run(cpu_context("unet_bf16.convert_b64",
                                           trace=1, dtype="float32"))
    finally:
        torch.set_num_threads(threads)
    assert line["correct"], (line, checks)
    got = line["metrics"]
    for name in ("pack_ms", "enqueue_ms", "loop_wait_ms",
                 "assemble_us_per_peak"):
        assert got[name]["value"] > 0, name
    # no device operation on the CPU: nothing to join
    assert "device_idle_assemble_pct" not in got
    assert "device_idle_enqueue_pct" not in got
