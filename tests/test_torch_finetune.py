"""train/finetune_robust.py and train/finetune_hard.py against the JAX
package's scripts/finetune_robust.py and scripts/finetune_hard.py, on the
CPU, through both main()s' host side.

Both sides run on the same small pool (EVAL_N 16, 16 train rows) at
batch 8 with the same recording stand-ins for their trainer, mesh and
clock (tests/torch_parity.py:RecipeStubs; the clock moves one second
inside each train step only, and the deadline is 20 s ahead, so the LR
drops to 1e-5 at 0.85 of the budget) and, for finetune_hard, for the
serving pipeline and the assembler (a fixed answer a drawing: the truth,
its canonical form, a wrong molecule or none). The JAX scripts' paths
derive from their own location, which is pointed at a temporary
directory. Each side starts from step 43100 (the JAX side's restore of
weights/, the port's committed snapshot through --ckpt) or resumes from
its own output directory at step 990, so that the run crosses the
1000-step checkpoint. Equal on both sides:
  * every collated host batch, bit for bit;
  * the learning-rate changes with their steps; the steps of the metrics
    calls, checkpoints and EVAL batches; the printed lines;
  * finetune_robust: the engine-B pool files, array by array (64 rows
    when its path is given);
  * finetune_hard: the mined indices, the cache file chosen (the newest
    prior cache by numeric step, 10000 over 900, or one named for the
    start step) and the FINAL report; the drawings served.
Also: `_same_mol` on a table of pairs, main()'s arguments and overrides,
the refusal without a GPU, and one real run of each on the CPU in f32
(the port's train_step, serving pipeline and assembler).

A `--ckpt` checkpoint directory is continued whole, as the scripts
restore theirs: both main()s on a plain UNet's step_*.pt written after
two real train steps start their first step (Loop.train stopped there)
from its weights, Adam moments and step, with the fine-tune's LR and the
generator of a fresh manual_seed(STEP_SEED). A checkpoint directory of
another model is refused, and so is an engine-B pool cached under the
default name with another number of rows than FT_B_POOL_N.
"""

import copy
import hashlib
import os
import shutil
import time

import numpy as np
import pytest
import torch

from abcnet_tpu_torch.chem import canonical_smiles
from abcnet_tpu_torch.data.pool import ensure_pool, load_pool
from abcnet_tpu_torch.train import finetune_hard as fh
from abcnet_tpu_torch.train import finetune_robust as fr
from abcnet_tpu_torch.train import recipe
from torch_parity import (RecipeStubs, load_script, run_script_main,
                          small_pool, stub_jax_script)

EVAL_N, TRAIN_N, BATCH, BUDGET_S = 16, 16, 8, 20.0
T0 = 1_000_000.0
SNAPSHOT_STEP = 43100
LOAD_LINES = ("pool loaded", "pool cached", "gen ")


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pool") / "pool.npz")
    small_pool(path, EVAL_N, TRAIN_N)
    return path


def _digest(image):
    return hashlib.sha256(np.ascontiguousarray(image).tobytes()).digest()


class FakeServing:
    """The serving pipeline (images in, images out) and an assembler
    that answers each drawing from the pool's truth by its digest: the
    truth, its canonical form (equal only after canonicalization), a
    wrong molecule, or nothing."""

    def __init__(self, pool_path):
        self.truth = {_digest(s.image): s.smiles
                      for s in load_pool(pool_path)}
        self.served = []

    def make(self, *args, **kwargs):
        def run(images):
            self.served.append(np.array(images))
            return np.array(images)
        return run

    def assemble(self, images):
        out = []
        for im in images:
            d = _digest(im)
            truth = self.truth[d]
            out.append([None, "C1CC1Cl", truth,
                        canonical_smiles(truth)][d[0] % 4])
        return out


def _lines(lines, side):
    skip = LOAD_LINES if side == "jax" else ("weights from",)
    return [x for x in lines if not x.startswith(skip)]


def run_robust(side, pool, root, capsys, monkeypatch, resume_step):
    stubs = RecipeStubs(side, resume_step or SNAPSHOT_STEP, T0)
    out = root / ("weights_robust" if side == "jax"
                  else "weights_torch_robust")
    out.mkdir(parents=True)
    if resume_step:
        (out / "step_x").write_text("")
    b_pool = str(root / "pool_b.npz")
    deadline = T0 + BUDGET_S
    if side == "jax":
        mod = load_script("finetune_robust")
        stub_jax_script(mod, stubs, str(root))
        mod.EVAL_N, mod.BATCH = EVAL_N, BATCH
        lines = run_script_main(mod, [deadline, pool, b_pool, out], capsys)
        res = None
    else:
        monkeypatch.setattr(fr, "trainer", stubs.torch_trainer())
        monkeypatch.setattr(recipe, "trainer", stubs.torch_trainer())
        lines = []
        res = fr.finetune_robust(deadline, pool, b_pool, str(out),
                                 eval_n=EVAL_N, batch=BATCH, device="cpu",
                                 clock=stubs.time, log=lines.append)
    return stubs, _lines(lines, side), res, b_pool


@pytest.mark.parametrize("resume_step", [0, 990])
def test_robust_host_side_equals_the_script(pool, tmp_path, capsys,
                                            monkeypatch, resume_step):
    js, jlines, _, jb = run_robust("jax", pool, tmp_path / "jax", capsys,
                                   monkeypatch, resume_step)
    ts, tlines, res, tb = run_robust("torch", pool, tmp_path / "torch",
                                     capsys, monkeypatch, resume_step)
    zj, zt = np.load(jb), np.load(tb)
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    assert len(zt["shapes"]) == 64
    assert len(ts.batches) == len(js.batches) == int(BUDGET_S)
    for i, (g, w) in enumerate(zip(ts.batches, js.batches)):
        assert sorted(g) == sorted(w), i
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")
    # the JAX side restores weights/ on a fresh start too; the port reads
    # its --ckpt snapshot
    assert [e for e in ts.events if e[0] != "restore"] == \
        [e for e in js.events if e[0] != "restore"]
    assert [e for e in ts.events if e[0] == "restore"] == \
        ([("restore",)] if resume_step else [])
    # the last two lines name each package's own output and commands
    assert tlines[:-2] == jlines[:-2]
    assert tlines[-2].split(";")[0] == jlines[-2].split(";")[0]
    start = resume_step or SNAPSHOT_STEP
    lrs = [e[1:] for e in ts.events if e[0] == "lr"]
    assert lrs == [(start, fr.LR), (start + 17, 1e-5)]
    ckpts = [e[1] for e in ts.events if e[0] == "ckpt"]
    assert ckpts == ([1000, 1010] if resume_step else [start + 20])
    assert res.steps == 20 and res.start_step == start
    assert any(f"(resume={bool(resume_step)})" in x for x in tlines)


def run_hard(side, pool, root, capsys, monkeypatch, resume_step,
             prior_cache):
    stubs = RecipeStubs(side, resume_step or SNAPSHOT_STEP, T0)
    serving = FakeServing(pool)
    out = root / ("weights" if side == "jax" else "weights_torch")
    out.mkdir(parents=True)
    if resume_step:
        (out / "step_x").write_text("")
    cache = root / "data_cache"
    cache.mkdir()
    prefix = "hard_idx_" if side == "jax" else fh.CACHE_PREFIX
    if prior_cache:
        np.save(cache / f"{prefix}10000.npy", np.array([3, 1, 4, 1, 5]))
        np.save(cache / f"{prefix}900.npy", np.array([2, 7]))
    deadline = T0 + BUDGET_S
    if side == "jax":
        mod = load_script("finetune_hard")
        stub_jax_script(mod, stubs, str(root))
        mod.EVAL_N, mod.BATCH, mod.MINE_BATCH = EVAL_N, BATCH, 4
        mod.make_infer_pipeline = serving.make
        mod.assemble_batch = serving.assemble
        lines = run_script_main(mod, [deadline, pool], capsys)
        res = None
    else:
        monkeypatch.setattr(fh, "trainer", stubs.torch_trainer())
        monkeypatch.setattr(recipe, "trainer", stubs.torch_trainer())
        monkeypatch.setattr(fh, "make_infer_pipeline", serving.make)
        monkeypatch.setattr(fh, "assemble_batch", serving.assemble)
        for k, v in (("EVAL_N", EVAL_N), ("BATCH", BATCH), ("MINE_BATCH", 4)):
            monkeypatch.setattr(fh, k, v)
        lines = []
        res = fh.finetune_hard(deadline, pool, out_ckpt=str(out),
                               cache_dir=str(cache), device="cpu",
                               clock=stubs.time, log=lines.append)
    caches = sorted(os.listdir(cache))
    return stubs, _lines(lines, side), res, serving, caches


@pytest.mark.parametrize("resume_step,prior_cache",
                         [(0, False), (990, True)])
def test_hard_host_side_equals_the_script(pool, tmp_path, capsys,
                                          monkeypatch, resume_step,
                                          prior_cache):
    js, jlines, _, jserv, jcache = run_hard(
        "jax", pool, tmp_path / "jax", capsys, monkeypatch, resume_step,
        prior_cache)
    ts, tlines, res, tserv, tcache = run_hard(
        "torch", pool, tmp_path / "torch", capsys, monkeypatch, resume_step,
        prior_cache)
    assert len(ts.batches) == len(js.batches) == int(BUDGET_S)
    for i, (g, w) in enumerate(zip(ts.batches, js.batches)):
        assert sorted(g) == sorted(w), i
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")
    assert [e for e in ts.events if e[0] != "restore"] == \
        [e for e in js.events if e[0] != "restore"]
    assert tlines == jlines
    assert [c.replace(fh.CACHE_PREFIX, "hard_idx_") for c in tcache] == \
        jcache
    assert len(tserv.served) == len(jserv.served)
    for g, w in zip(tserv.served, jserv.served):
        np.testing.assert_array_equal(g, w)
    start = resume_step or SNAPSHOT_STEP
    if prior_cache:
        np.testing.assert_array_equal(res.hard_idx, [3, 1, 4, 1, 5])
        assert "mined cache: 5 hard examples" in tlines
        assert len(tserv.served) == 1             # FINAL only
    else:
        assert tcache == [f"{fh.CACHE_PREFIX}{start}.npy"]
        want = [i for i, im in enumerate(np.concatenate(tserv.served[:4]))
                if _digest(im)[0] % 4 < 2]
        np.testing.assert_array_equal(res.hard_idx, want)
        assert 0 < len(want) < TRAIN_N
        assert len(tserv.served) == 4 + 1         # 4 mining + FINAL
    lrs = [e[1:] for e in ts.events if e[0] == "lr"]
    assert lrs == [(start, fh.LR), (start + 17, 1e-5)]
    final = [x for x in tlines if x.startswith("FINAL ")]
    assert final == [f"FINAL {res.final}"] and res.final.n == EVAL_N
    assert res.steps == int(BUDGET_S)


def test_same_mol_equals_the_scripts():
    mod = load_script("finetune_hard")
    pairs = [(None, "CCO"), ("CCO", "CCO"), ("OCC", "CCO"),
             ("C1=CC=CC=C1", "c1ccccc1"), ("c1ccccc1", "C1=CC=CC=C1"),
             ("CC(=O)O", "CC(O)=O"), ("CCN", "CCO"), ("C((", "CCO"),
             ("CCO", "C(("), ("", "C"), ("[NH4+]", "N"),
             ("C/C=C/C", "C/C=C\\C"), ("N[C@@H](C)C(=O)O",
                                       "N[C@H](C)C(=O)O")]
    got = [fh._same_mol(p, t) for p, t in pairs]
    assert got == [mod._same_mol(p, t) for p, t in pairs]
    assert got[:5] == [False, True, True, True, True] and not got[6]


def test_constants_are_the_scripts():
    rob, hard = load_script("finetune_robust"), load_script("finetune_hard")
    assert (fr.EVAL_N, fr.BATCH, fr.LR, fr.DEGRADE_P, fr.B_FRAC,
            fr.B_POOL_N) == (rob.EVAL_N, rob.BATCH, rob.LR, rob.DEGRADE_P,
                             rob.B_FRAC, rob.B_POOL_N)
    assert (fh.EVAL_N, fh.BATCH, fh.LR, fh.HARD_FRAC, fh.MINE_BATCH) == \
        (hard.EVAL_N, hard.BATCH, hard.LR, hard.HARD_FRAC, hard.MINE_BATCH)
    grid = list(np.linspace(0, 1, 101)) + [0.85]
    assert [recipe.finetune_lr(f, 2.5e-5) for f in grid] == \
        [2.5e-5 if f < 0.85 else 1e-5 for f in grid]


def test_cache_choice_is_numeric(tmp_path):
    assert fh.cache_path(str(tmp_path), 7) == str(
        tmp_path / f"{fh.CACHE_PREFIX}7.npy")
    for name in ("torch_hard_idx_56000.npy", "torch_hard_idx_100000.npy",
                 "torch_hard_idx_9.npy", "hard_idx_999999.npy",
                 "torch_hard_idx_x.npy"):
        (tmp_path / name).write_bytes(b"")
    assert fh.cache_path(str(tmp_path), 7) == str(
        tmp_path / "torch_hard_idx_100000.npy")


def test_main_arguments_and_overrides(monkeypatch):
    seen = {}
    monkeypatch.setattr(fr, "finetune_robust",
                        lambda *a, **kw: seen.update(args=a, kw=kw))
    for k, v in (("FT_EVAL_N", "5"), ("FT_BATCH", "6"), ("FT_LR", "1e-4"),
                 ("FT_DEGRADE_P", "0.1"), ("FT_B_FRAC", "0.5"),
                 ("FT_HARD", "0"), ("FT_B_POOL_N", "3000")):
        monkeypatch.setenv(k, v)
    fr.main(["9.5", "p.npz", "b.npz", "out", "--ckpt", "c.npz",
             "--device", "cpu"])
    assert seen["args"] == (9.5, "p.npz", "b.npz", "out")
    assert {k: seen["kw"][k] for k in (
        "ckpt", "eval_n", "batch", "lr", "degrade_p", "b_frac", "hard",
        "b_pool_n", "device")} == {
        "ckpt": "c.npz", "eval_n": 5, "batch": 6, "lr": 1e-4,
        "degrade_p": 0.1, "b_frac": 0.5, "hard": False, "b_pool_n": 3000,
        "device": "cpu"}
    seen.clear()
    monkeypatch.setattr(fh, "finetune_hard",
                        lambda *a, **kw: seen.update(args=a, kw=kw))
    fh.main(["9.5"])
    assert seen["args"] == (9.5, fh.DEFAULT_POOL)
    assert seen["kw"]["ckpt"] == recipe.DEFAULT_SNAPSHOT
    assert os.path.basename(seen["kw"]["out_ckpt"]) == "weights_torch"
    assert seen["kw"]["device"] == "cuda"


def test_refuse_without_a_gpu(pool):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for main in (fr.main, fh.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["1", pool])


def one_step_clock(monkeypatch):
    """(deadline, clock): the clock passes the deadline once the first
    train step has run, so a real run takes exactly one step."""
    done, train = [], recipe.Loop.train

    def counting(self, *a, **kw):
        done.append(1)
        return train(self, *a, **kw)
    monkeypatch.setattr(recipe.Loop, "train", counting)
    return 50.0, lambda: 100.0 if done else 0.0


@pytest.fixture(scope="module")
def tiny_pool(tmp_path_factory):
    """2 eval rows and 4 train rows, and the 64-row engine-B pool: one
    real run stays seconds long."""
    root = tmp_path_factory.mktemp("tiny")
    small_pool(str(root / "pool.npz"), 2, 4)
    ensure_pool(str(root / "b.npz"), 64, sample_fn=fr._gen_b, seed=31)
    return str(root / "pool.npz")


def test_one_real_robust_run_on_the_cpu(tiny_pool, tmp_path, monkeypatch):
    """finetune_robust in f32 from the committed snapshot with the port's
    own train_step (the plain step): one step, a checkpoint
    that resumes, an EVAL at batch 2."""
    monkeypatch.setattr(recipe, "EVAL_BATCH", 2)
    lines = []
    out = tmp_path / "out"
    deadline, clock = one_step_clock(monkeypatch)
    b_pool = os.path.join(os.path.dirname(tiny_pool), "b.npz")
    res = fr.finetune_robust(deadline, tiny_pool, b_pool,
                             str(out), eval_n=2, batch=2, device="cpu",
                             dtype="float32", clock=clock, log=lines.append)
    assert res.start_step == SNAPSHOT_STEP and res.steps == 1
    assert res.checkpoints == [SNAPSHOT_STEP + 1]
    assert os.listdir(out) == [f"step_{SNAPSHOT_STEP + 1:08d}.pt"]
    (_, avg), = res.evals
    assert avg and all(np.isfinite(v) for v in avg.values())
    state, resumed = recipe.finetune_state(
        fr.trainer.TrainConfig(dtype="float32", device="cpu"),
        recipe.DEFAULT_SNAPSHOT, str(out))
    assert resumed and state.step == SNAPSHOT_STEP + 1
    assert state.model.remat_blocks == frozenset()


def test_one_real_hard_run_on_the_cpu(tiny_pool, tmp_path, monkeypatch):
    """finetune_hard in f32 from the committed snapshot: the mining sweep
    through the real serving pipeline and assembler, one step, FINAL over
    the 2 eval rows."""
    monkeypatch.setattr(recipe, "EVAL_BATCH", 2)
    for k in ("EVAL_N", "BATCH", "MINE_BATCH"):
        monkeypatch.setattr(fh, k, 2)
    lines = []
    deadline, clock = one_step_clock(monkeypatch)
    res = fh.finetune_hard(deadline, tiny_pool,
                           out_ckpt=str(tmp_path / "out"), clock=clock,
                           cache_dir=str(tmp_path / "cache"), device="cpu",
                           dtype="float32", log=lines.append)
    cached = np.load(tmp_path / "cache" / f"{fh.CACHE_PREFIX}"
                                          f"{SNAPSHOT_STEP}.npy")
    np.testing.assert_array_equal(res.hard_idx, cached)
    assert res.steps == 1 and res.final.n == 2
    assert any(x.startswith("mined ") for x in lines)
    assert lines[-1] == f"FINAL {res.final}"


class _FirstStep(Exception):
    """Raised where a fine-tune would take its first train step."""


def stop_at_first_step(monkeypatch):
    """Loop.train made to record the state it is handed, then to stop the
    run: what the fine-tune starts its first step from (after its
    generator reseed and its LR set)."""
    seen = {}

    def record(self, examples, epoch=None):
        st = self.state
        seen.update(step=st.step,
                    optimizer=copy.deepcopy(st.optimizer.state_dict()),
                    lrs=[g["lr"] for g in st.optimizer.param_groups],
                    generator=st.generator.get_state(),
                    model={k: v.clone()
                           for k, v in st.model.state_dict().items()},
                    remat=st.model.remat_blocks)
        raise _FirstStep
    monkeypatch.setattr(recipe.Loop, "train", record)
    return seen


@pytest.fixture(scope="module")
def plain_checkpoint(tmp_path_factory):
    """(directory, file): a plain production UNet (no remat) after two
    real f32 train steps at LR 1e-3 on 64² synthetic images, saved by
    trainer.save_checkpoint: Adam moments that are not zero, step 2."""
    from abcnet_tpu_torch.data.pipeline import synthetic_batch
    from abcnet_tpu_torch.train import trainer

    state = trainer.create_state(trainer.TrainConfig(
        device="cpu", dtype="float32", lr=1e-3))
    assert not state.model.remat_blocks
    batch = trainer.to_device(synthetic_batch(2, seed=1, size=64), "cpu")
    for _ in range(2):
        trainer.train_step(state, batch, with_metrics=False)
    root = tmp_path_factory.mktemp("plain_ckpt")
    return str(root), trainer.save_checkpoint(state, str(root))


def assert_continues_the_checkpoint(seen, path, lr, step_seed):
    """The state before the first fine-tune step holds the checkpoint's
    weights, Adam moments and step, the fine-tune's LR, and the generator
    of a fresh manual_seed(step_seed)."""
    ck = torch.load(path, weights_only=True)
    assert seen["step"] == ck["step"] == 2
    want, got = ck["optimizer"]["state"], seen["optimizer"]["state"]
    assert want and sorted(got) == sorted(want)
    for i in want:
        assert sorted(got[i]) == sorted(want[i])
        for k in want[i]:
            assert torch.equal(got[i][k], want[i][k]), (i, k)
    assert any(float(v["exp_avg"].abs().max()) > 0 for v in want.values())
    assert [g["lr"] for g in ck["optimizer"]["param_groups"]] == [1e-3]
    assert seen["lrs"] == [lr]
    assert torch.equal(seen["generator"],
                       torch.Generator().manual_seed(step_seed).get_state())
    # the plain UNet, its parameters loaded by name
    assert seen["remat"] == frozenset()
    assert sorted(seen["model"]) == sorted(ck["model"])
    for k, v in ck["model"].items():
        assert torch.equal(seen["model"][k], v), k


def test_robust_continues_a_checkpoint_directory_whole(
        tiny_pool, plain_checkpoint, tmp_path, monkeypatch, capsys):
    ckpt_dir, path = plain_checkpoint
    seen = stop_at_first_step(monkeypatch)
    monkeypatch.setenv("FT_EVAL_N", "2")
    monkeypatch.setenv("FT_BATCH", "2")
    b_pool = os.path.join(os.path.dirname(tiny_pool), "b.npz")
    with pytest.raises(_FirstStep):
        fr.main([repr(time.time() + 3600), tiny_pool, b_pool,
                 str(tmp_path / "out"), "--ckpt", ckpt_dir,
                 "--device", "cpu"])
    assert_continues_the_checkpoint(seen, path, fr.LR, fr.STEP_SEED)
    out = capsys.readouterr().out
    assert "start step 2 (resume=False)" in out
    assert "fresh Adam moments" not in out


def test_hard_continues_a_checkpoint_directory_whole(
        tiny_pool, plain_checkpoint, tmp_path, monkeypatch, capsys):
    ckpt_dir, path = plain_checkpoint
    seen = stop_at_first_step(monkeypatch)
    for k in ("EVAL_N", "BATCH"):
        monkeypatch.setattr(fh, k, 2)
    cache = tmp_path / "cache"
    cache.mkdir()
    np.save(cache / f"{fh.CACHE_PREFIX}2.npy", np.array([0, 3]))
    with pytest.raises(_FirstStep):
        fh.main([repr(time.time() + 3600), tiny_pool, "--ckpt", ckpt_dir,
                 "--out", str(tmp_path / "other"), "--cache-dir",
                 str(cache), "--device", "cpu"])
    assert_continues_the_checkpoint(seen, path, fh.LR, fh.STEP_SEED)
    out = capsys.readouterr().out
    assert "start step 2" in out and "fresh Adam moments" not in out


@pytest.mark.parametrize("variant", ["s2d", "fused_head_bank"])
def test_a_checkpoint_directory_of_another_model_is_refused(tmp_path,
                                                            variant):
    from abcnet_tpu_torch.models.unet import UNet
    from abcnet_tpu_torch.models.unet_s2d import UNetS2D
    from abcnet_tpu_torch.train import trainer

    model = UNetS2D() if variant == "s2d" else UNet(fused_head_bank=True)
    cfg = trainer.TrainConfig(device="cpu", dtype="float32")
    trainer.save_checkpoint(trainer.create_state(cfg, model=model),
                            str(tmp_path / "src"))
    with pytest.raises(ValueError, match="production UNet, not a " + (
            "UNetS2D" if variant == "s2d" else
            "UNet with a fused head bank")):
        recipe.finetune_state(cfg, str(tmp_path / "src"),
                              str(tmp_path / "out"))


@pytest.mark.parametrize("b_pool_n", [500, 1500])
def test_a_default_b_pool_of_another_size_is_refused(tiny_pool, tmp_path,
                                                      monkeypatch, b_pool_n):
    """The 64-row engine-B pool cached under the name that FT_B_POOL_N
    derives (pool_b_0k.npz, pool_b_1k.npz) does not stand in for it."""
    cache = tmp_path / "data_cache"
    cache.mkdir()
    name = f"pool_b_{b_pool_n // 1000}k.npz"
    shutil.copy(os.path.join(os.path.dirname(tiny_pool), "b.npz"),
                cache / name)
    monkeypatch.setattr(recipe, "DATA_CACHE", str(cache))
    with pytest.raises(ValueError, match=rf"{name} holds 64 samples, "
                                         rf"{b_pool_n} asked for"):
        fr.finetune_robust(1.0, tiny_pool, out_ckpt=str(tmp_path / "out"),
                           b_pool_n=b_pool_n, device="cpu",
                           log=lambda line: None)
