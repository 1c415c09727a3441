"""img2smiles CLI serving-loop mechanics (no device work).

The loop is double-buffered: batch i+1's device program is dispatched
before batch i's host assembly (overlap — the reference serializes the
two, img2smiles2.py:52-317). These tests monkeypatch the device and
assembly stages to verify ordering, trailing-batch padding (the
reference scores every row, img2smiles2.py:342-344) and result order:
first the JAX package's CLI, then the port's loop
(abcnet_tpu_torch.__main__.img2smiles_loop), which assembles each batch
on its fetch worker and keeps at most two batches pending.
"""

import argparse
import os
import threading
import time

import numpy as np
import pytest


class _FakeSample:
    def __init__(self, i):
        self.image = np.full((8, 8), i, np.uint8)
        self.smiles = "C"


def _run_cli(tmp_path, monkeypatch, n_samples, bs, split=False):
    from abcnet_tpu import __main__ as cli

    events = []
    samples = [_FakeSample(i) for i in range(n_samples)]

    csv = tmp_path / "dataset.csv"
    csv.write_text("Smiles,atoms_string,bonds_string,path\n")

    from abcnet_tpu.data import pipeline as pl
    from abcnet_tpu.infer import decode as dec
    from abcnet_tpu.train import trainer as tr
    from abcnet_tpu import infer as inf

    monkeypatch.setattr(pl, "load_csv_dataset", lambda p: samples)
    monkeypatch.setattr(tr, "create_state", lambda cfg: object())

    def fake_make_pipeline(state, mesh=None, threshold=0.6):
        def run(images):
            assert images.shape[0] == bs, "trailing chunk must be padded"
            events.append(("run", int(images[0, 0, 0])))
            # peaks stand-in: first-pixel tags of the batch images
            return images[:, 0, 0].copy()
        if split:
            # Production pipelines expose the async dispatch/fetch
            # split; the CLI must use it with identical results.
            run.dispatch = run
            run.fetch = lambda h: (events.append(("fetch", int(h[0])))
                                   or h)
        return run

    def fake_assemble(peaks, processes=None, pool=None):
        events.append(("asm", int(peaks[0])))
        return ["C" for _ in peaks]

    monkeypatch.setattr(dec, "make_infer_pipeline", fake_make_pipeline)
    monkeypatch.setattr(inf, "assemble_batch", fake_assemble)

    out = tmp_path / "results.csv"
    args = argparse.Namespace(
        data=str(csv), out=str(out), ckpt=None, dtype="float32",
        batch_size=bs, mesh=None, threshold=0.6, processes=None)
    cli._cmd_img2smiles(args)
    return events, out


def test_double_buffered_order(tmp_path, monkeypatch, capsys):
    events, out = _run_cli(tmp_path, monkeypatch, n_samples=12, bs=4)
    runs = [e for e in events if e[0] == "run"]
    asms = [e for e in events if e[0] == "asm"]
    assert len(runs) == 3 and len(asms) == 3
    # Dispatch of batch i+1 precedes assembly of batch i (overlap),
    # and assemblies complete in order.
    assert events[0] == ("run", 0)
    assert events[1] == ("run", 4)
    assert events[2] == ("asm", 0)
    assert events[-1] == ("asm", 8)
    assert [a[1] for a in asms] == [0, 4, 8]


def test_split_pipeline_threaded_fetch(tmp_path, monkeypatch, capsys):
    """With a dispatch/fetch pipeline the CLI downloads on a worker
    thread; dispatch order and assembly order/results are unchanged."""
    events, out = _run_cli(tmp_path, monkeypatch, n_samples=12, bs=4,
                           split=True)
    runs = [e for e in events if e[0] == "run"]
    asms = [e for e in events if e[0] == "asm"]
    fets = [e for e in events if e[0] == "fetch"]
    assert [r[1] for r in runs] == [0, 4, 8]
    assert [a[1] for a in asms] == [0, 4, 8]
    assert sorted(f[1] for f in fets) == [0, 4, 8]
    import pandas as pd
    assert len(pd.read_csv(out)) == 12


def test_trailing_batch_padded_and_scored(tmp_path, monkeypatch, capsys):
    events, out = _run_cli(tmp_path, monkeypatch, n_samples=10, bs=4)
    # Every sample scored: 10 rows despite 10 % 4 != 0.
    import pandas as pd
    df = pd.read_csv(out)
    assert len(df) == 10
    assert (df["smiles"] == "C").all()


def test_smaller_than_batch_dataset(tmp_path, monkeypatch, capsys):
    events, out = _run_cli(tmp_path, monkeypatch, n_samples=3, bs=8)
    import pandas as pd
    df = pd.read_csv(out)
    assert len(df) == 3  # ADVICE r1: used to produce an empty csv


# ---------------------------------------------------------------------------
# The port's loop: fetch and assembly on the worker thread
# ---------------------------------------------------------------------------

class _TaggedPipeline:
    """dispatch -> first pixel of each image (the batch's tag rows); fetch
    on the worker thread. Counts the batches dispatched and the most
    that were dispatched before a dispatch and not yet assembled."""

    def __init__(self, assembled=None):
        self.assembled = assembled
        self.dispatched = []
        self.fetch_threads = set()
        self.most_outstanding = 0

    def dispatch(self, batch):
        if self.assembled is not None:
            with self.assembled["lock"]:
                done = self.assembled["n"]
            self.most_outstanding = max(self.most_outstanding,
                                        len(self.dispatched) - done)
        self.dispatched.append(len(batch))
        return batch[:, 0, 0].copy()

    def fetch(self, handle):
        self.fetch_threads.add(threading.get_ident())
        return handle


def _torch_loop(run, n_images, bs, assemble):
    from abcnet_tpu_torch import __main__ as tcli
    images = [np.full((4, 4), i, np.uint8) for i in range(n_images)]
    return tcli.img2smiles_loop(run, images, bs, log_every=0,
                                assemble=assemble)


@pytest.mark.parametrize("n_images,bs", [(7, 3), (12, 4), (2, 5)])
def test_torch_loop_batch_order_and_padding(n_images, bs):
    run = _TaggedPipeline()
    got = _torch_loop(run, n_images, bs,
                      lambda peaks: [str(v) for v in peaks])
    assert got == [str(i) for i in range(n_images)]
    assert run.dispatched == [bs] * -(-n_images // bs)   # all padded


def test_torch_loop_assembles_off_the_loop_thread():
    run, threads = _TaggedPipeline(), []

    def assemble(peaks):
        threads.append(threading.get_ident())
        return list(peaks)
    _torch_loop(run, 9, 2, assemble)
    assert len(threads) == 5
    assert threading.get_ident() not in threads
    # one worker fetches and assembles every batch
    assert set(threads) == run.fetch_threads and len(set(threads)) == 1


def test_torch_loop_keeps_at_most_two_batches_pending():
    """A batch is collected only once two later ones are dispatched: when
    batch n is dispatched, batches 0..n-3 were collected (so assembled),
    and with assembly slower than dispatch two are still outstanding."""
    assembled = {"lock": threading.Lock(), "n": 0}
    run = _TaggedPipeline(assembled)

    def assemble(peaks):
        time.sleep(0.02)
        with assembled["lock"]:
            assembled["n"] += 1
        return list(peaks)
    got = _torch_loop(run, 16, 2, assemble)
    assert got == list(range(16))
    assert run.most_outstanding == 2


@pytest.mark.parametrize("stage", ["fetch", "assemble"])
def test_torch_loop_error_reaches_the_caller(stage):
    """An error in a batch's fetch or assembly is raised by the loop, and
    the worker thread is gone once it returns."""
    workers = []

    class Broken(_TaggedPipeline):
        def fetch(self, handle):
            workers.append(threading.current_thread())
            if stage == "fetch" and handle[0] == 2:
                raise RuntimeError("fetch failed")
            return handle

    def assemble(peaks):
        if stage == "assemble" and peaks[0] == 2:
            raise RuntimeError("assemble failed")
        return list(peaks)
    with pytest.raises(RuntimeError, match=f"{stage} failed"):
        _torch_loop(Broken(), 12, 2, assemble)
    assert workers
    for t in workers:
        t.join(timeout=10)
        assert not t.is_alive()
