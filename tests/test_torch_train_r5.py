"""train/train_r5.py against the JAX package's scripts/train_r5.py, on the
CPU, through both main()s' host side.

Both trainers run on the same small pool (EVAL_N 16, 16 train rows, made
by the port's build_pool_r5) at batch 4 with the same recording
stand-ins for their trainer, mesh, snapshot and clock
(tests/torch_parity.py:RecipeStubs): the clock moves one second inside
each train step and nowhere else, the deadline is 30 s ahead with a
30-second budget, so all three learning rates are reached. Fresh, and
resumed from step 2480 (so the run crosses the 2500-step checkpoint)
with the commit interval cut to 5 steps on both sides. Equal on both
sides:
  * every collated host batch, bit for bit (the eval split's
    random.Random(1), then the epoch permutations and augmentation);
  * the learning-rate changes with their steps; the steps of the
    metrics calls, checkpoints, snapshots (with their commit flag) and
    EVAL batches;
  * the printed lines (the log, LR, EVAL, start and end lines);
  * the atom-type weights in force at every step (ATOM_W_R5), and the
    port restores the default after the run.
Also: lr_for_fraction on a grid, main()'s arguments and environment
overrides, the refusal without a GPU, the float16 snapshot against
scripts/snapshot_weights.py:save, the git commit and its logged
failure, and one real run on the CPU in f32 (the port's train_step).
"""

import os
import subprocess
import types

import numpy as np
import pytest
import torch

from abcnet_tpu_torch.models.unet import UNet
from abcnet_tpu_torch.models.weights import (f16_is_exact, load_snapshot,
                                             save_snapshot_f16, to_flax)
from abcnet_tpu_torch.ops import losses as L
from abcnet_tpu_torch.train import recipe
from abcnet_tpu_torch.train import train_r5 as tr
from torch_parity import (RecipeStubs, load_script, run_script_main,
                          small_pool, stub_jax_script)

EVAL_N, TRAIN_N, BATCH, BUDGET_S = 16, 16, 4, 30.0
T0 = 1_000_000.0


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pool") / "pool_r5.npz")
    small_pool(path, EVAL_N, TRAIN_N)
    return path


@pytest.fixture
def default_atom_weights():
    """Both packages' module-global loss weights back to their defaults
    after the test (the JAX script sets them and leaves them)."""
    from abcnet_tpu.ops import losses as jax_losses
    jax_w, w = jax_losses._ATOM_W.copy(), L.get_atom_type_weights()
    yield
    jax_losses.set_atom_type_weights(jax_w)
    L.set_atom_type_weights(w)


def run_both(pool, tmp_path, capsys, monkeypatch, resume_step):
    """(JAX stubs, JAX lines, port stubs, port lines, port result)."""
    from abcnet_tpu.ops import losses as jax_losses

    deadline = T0 + BUDGET_S
    total_h = BUDGET_S / 3600
    out = {}
    for side in ("jax", "torch"):
        root = tmp_path / side
        ckpt = root / ("weights" if side == "jax" else "weights_torch")
        ckpt.mkdir(parents=True)
        if resume_step:
            (ckpt / "step_x").write_text("")
        read_w = (lambda: jax_losses._ATOM_W) if side == "jax" else \
            L.get_atom_type_weights
        stubs = RecipeStubs(side, resume_step, T0, atom_w=read_w)
        if side == "jax":
            mod = load_script("train_r5")
            stub_jax_script(mod, stubs, str(root))
            mod.EVAL_N = EVAL_N
            mod.SNAPSHOT_COMMIT_EVERY = 5
            mod.snapshot_and_maybe_commit = \
                lambda ckpt_dir, step, commit: stubs.snapshot(step, commit)
            monkeypatch.setenv("R5_BATCH", str(BATCH))
            lines = run_script_main(mod, [deadline, total_h, pool], capsys)
            lines = [x for x in lines if not x.startswith("pool loaded")]
            res = None
        else:
            monkeypatch.setattr(tr, "trainer", stubs.torch_trainer())
            monkeypatch.setattr(recipe, "trainer", stubs.torch_trainer())
            monkeypatch.setattr(tr, "SNAPSHOT_COMMIT_EVERY", 5)
            monkeypatch.setattr(
                recipe, "snapshot_and_commit",
                lambda model, path, step, commit, log:
                stubs.snapshot(step, commit) or True)
            lines = []
            res = tr.train_r5(deadline, total_h, pool, eval_n=EVAL_N,
                              batch=BATCH, ckpt_dir=str(ckpt),
                              snapshot_path=str(root / "snap.npz"),
                              device="cpu", clock=stubs.time,
                              log=lines.append)
        out[side] = (stubs, lines, res)
    return out


@pytest.mark.parametrize("resume_step", [0, 2480])
def test_host_side_equals_the_scripts(pool, tmp_path, capsys, monkeypatch,
                                      default_atom_weights, resume_step):
    out = run_both(pool, tmp_path, capsys, monkeypatch, resume_step)
    (js, jlines, _), (ts, tlines, res) = out["jax"], out["torch"]
    assert len(ts.batches) == len(js.batches) == 31
    for i, (g, w) in enumerate(zip(ts.batches, js.batches)):
        assert sorted(g) == sorted(w), i
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{i} {k}")
    assert ts.events == js.events
    assert tlines == jlines
    lrs = [e[1:] for e in ts.events if e[0] == "lr"]
    assert [lr for _, lr in lrs] == [2.5e-4, 2.5e-5, 1e-5]
    assert lrs[0][0] == resume_step < lrs[1][0] < lrs[2][0]
    assert [x.split()[2] for x in tlines if x.startswith("lr -> ")] == [
        "0.00025", "2.5e-05", "1e-05"]
    snaps = [e[1:] for e in ts.events if e[0] == "snapshot"]
    ckpts = [e[1] for e in ts.events if e[0] == "ckpt"]
    if resume_step:
        assert snaps == [(2500, True), (2511, True)] and ckpts == [2500, 2511]
        assert any(x.startswith("ep ") and " step 2500 " in x
                   for x in tlines)
    else:
        assert snaps == [(31, True)] and ckpts == [31]
    evals = [x for x in tlines if x.startswith("EVAL ")]
    assert evals and all("atom_target_precision=0.7500" in x for x in evals)
    assert tlines[-1] == "RUN COMPLETE"
    assert ts.atom_ws and len(ts.atom_ws) == len(js.atom_ws)
    assert all(np.array_equal(w, np.float32(tr.ATOM_W_R5))
               for w in ts.atom_ws + js.atom_ws)
    np.testing.assert_array_equal(L.get_atom_type_weights(),
                                  np.asarray(L.vocab.ATOM_TYPE_WEIGHTS,
                                             np.float32))
    assert res.steps == 31 and res.metrics_steps == sum(
        e[0] == "metrics" for e in ts.events)


def test_lr_for_fraction_on_a_grid():
    mod = load_script("train_r5")
    grid = list(np.linspace(-0.2, 1.2, 141)) + [1 / 3, 0.8, 0.0, 1.0]
    for base in (2.5e-4, 1e-3):
        assert [recipe.lr_for_fraction(f, base) for f in grid] == \
            [mod.lr_for_fraction(f, base) for f in grid]
    assert tr.ATOM_W_R5 == mod.ATOM_W_R5
    assert (tr.EVAL_N, tr.DEGRADE_P, tr.SNAPSHOT_COMMIT_EVERY) == \
        (mod.EVAL_N, mod.DEGRADE_P, mod.SNAPSHOT_COMMIT_EVERY)


def test_main_arguments_and_overrides(monkeypatch):
    seen = {}
    monkeypatch.setattr(tr, "train_r5",
                        lambda *a, **kw: seen.update(args=a, kw=kw))
    monkeypatch.setenv("R5_EVAL_N", "7")
    monkeypatch.setenv("R5_BATCH", "3")
    monkeypatch.setenv("R5_DEGRADE_P", "0.5")
    tr.main(["123.5", "2", "p.npz", "--device", "cpu", "--ckpt-dir", "ck",
             "--snapshot", "s.npz"])
    assert seen["args"] == (123.5, 2.0, "p.npz")
    kw = seen["kw"]
    assert (kw["eval_n"], kw["batch"], kw["degrade_p"], kw["ckpt_dir"],
            kw["snapshot_path"], kw["device"]) == (7, 3, 0.5, "ck", "s.npz",
                                                    "cpu")
    monkeypatch.delenv("R5_BATCH")
    tr.main(["1", "1"])
    assert seen["args"][2] == tr.DEFAULT_POOL
    assert seen["kw"]["batch"] == 64
    assert seen["kw"]["snapshot_path"].endswith(
        os.path.join("snapshots", "r5_torch_latest.npz"))
    assert os.path.basename(seen["kw"]["ckpt_dir"]) == "weights_torch"


def test_refuses_without_a_gpu(pool):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.main(["1", "1", pool])


def _edge_case_model():
    """The production UNet with one kernel holding a subnormal value
    whose f16 rounding changes its bf16 bits and one holding a value
    past float16's range: both must stay f32."""
    torch.manual_seed(3)
    model = UNet()
    with torch.no_grad():
        model.inc1.conv0.weight.view(-1)[0] = 3.0e-7
        model.down1.double_conv.conv1.weight.view(-1)[5] = 70000.0
        model.inc1.bn0.running_mean.add_(0.25)
    return model


def test_snapshot_f16_equals_snapshot_weights_save(tmp_path, monkeypatch):
    import jax

    mod = load_script("snapshot_weights")
    model = _edge_case_model()
    params, stats = to_flax(model.state_dict())
    state = jax.tree_util.tree_map(np.asarray, {"p": params, "s": stats})

    class _Trainer:
        TrainConfig = staticmethod(lambda: None)
        create_state = staticmethod(lambda cfg: None)

        @staticmethod
        def restore_checkpoint(st, ckpt_dir):
            import types
            return types.SimpleNamespace(step=np.int32(777),
                                         params=state["p"],
                                         batch_stats=state["s"])

    import abcnet_tpu.train as jax_train
    monkeypatch.setattr(jax_train, "trainer", _Trainer, raising=False)
    monkeypatch.setitem(__import__("sys").modules,
                        "abcnet_tpu.train.trainer", _Trainer)
    monkeypatch.setattr(mod, "REPO", str(tmp_path))
    want = np.load(mod.save(str(tmp_path / "weights"), "r5"))
    logged = []
    path = save_snapshot_f16(model, str(tmp_path / "port.npz"), 777,
                             logged.append)
    got = np.load(path)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # f16 double rounding moves
    # some values of a random init onto a bf16 tie, so more arrays than
    # the two edited ones stay f32
    f32 = [k for k in want.files
           if k.startswith("params/") and want[k].dtype == np.float32]
    assert sorted(logged) == sorted(f"  [f16-unsafe] {k}: stored float32"
                                    for k in f32)
    assert {"params/down1/DoubleConv_0/Conv_1/kernel",
            "params/inc1/Conv_0/kernel"} <= set(f32)
    assert any(want[k].dtype == np.float16 for k in want.files)
    assert int(got["__step__"]) == 777
    assert all(got[k].dtype == np.float32 for k in got.files
               if k.startswith("batch_stats/"))
    loaded, step = load_snapshot(path, device="cpu")
    assert step == 777 and isinstance(loaded, UNet)
    assert not os.path.exists(path + ".tmp.npz")


def test_bf16_rounding_equals_ml_dtypes():
    import ml_dtypes
    rng = np.random.default_rng(0)
    v = np.concatenate([
        rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(
            -40, 38, 4096),
        np.array([0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 65504.0,
                  65520.0, 3.0e-7, 6.1e-5, 2 ** -24, np.inf, -np.inf],
                 np.float32)])
    got = torch.from_numpy(v).to(torch.bfloat16).view(torch.int16).numpy()
    want = v.astype(ml_dtypes.bfloat16).view(np.int16)
    np.testing.assert_array_equal(got, want)
    for a in (v[:64], np.array([3.0e-7], np.float32),
              np.array([70000.0], np.float32),
              np.array([0.5, -2.0], np.float32)):
        f16 = a.astype(np.float16)
        ref = bool(np.isfinite(f16).all() and np.array_equal(
            f16.astype(np.float32).astype(ml_dtypes.bfloat16).view(
                np.uint16), a.astype(ml_dtypes.bfloat16).view(np.uint16)))
        assert f16_is_exact(a) == ref


def test_commit_in_a_repository_and_a_logged_failure(tmp_path,
                                                     monkeypatch):
    for k in ("GIT_AUTHOR_NAME", "GIT_COMMITTER_NAME"):
        monkeypatch.setenv(k, "t")
    for k in ("GIT_AUTHOR_EMAIL", "GIT_COMMITTER_EMAIL"):
        monkeypatch.setenv(k, "t@t")
    monkeypatch.setenv("GIT_CONFIG_GLOBAL", os.devnull)
    repo = tmp_path / "repo"
    subprocess.run(["git", "init", "-q", str(repo)], check=True)
    snap = repo / "snap.npz"
    snap.write_bytes(b"x")
    logged, slept = [], []
    # recipe's own retry sleeps only: subprocess's wait polls through the
    # time module's sleep while git is still running
    monkeypatch.setattr(recipe, "time", types.SimpleNamespace(
        sleep=slept.append))
    recipe.commit_snapshot(str(snap), 2500, logged.append)
    log = subprocess.run(["git", "-C", str(repo), "log", "--format=%s"],
                         capture_output=True, text=True).stdout
    assert log.strip() == "r5 training snapshot at step 2500"
    assert len(logged) == 1 and logged[0].startswith(
        "[snapshot] commit step 2500: rc=0 ") and not slept
    outside = tmp_path / "plain"
    outside.mkdir()
    (outside / "snap.npz").write_bytes(b"x")
    logged.clear()
    recipe.commit_snapshot(str(outside / "snap.npz"), 5, logged.append)
    assert len(logged) == 3 and all(
        x.startswith(f"[snapshot] git attempt {i}: ")
        for i, x in enumerate(logged))
    assert slept == [recipe.COMMIT_RETRY_S] * 3
    # a snapshot that cannot be written is logged, and nothing raises
    logged.clear()
    ok = recipe.snapshot_and_commit(UNet(), str(outside / "f" / "s.npz"),
                                    9, True, logged.append)
    assert ok and os.path.exists(outside / "f" / "s.npz")
    (outside / "ro").write_text("")
    logged.clear()
    ok = recipe.snapshot_and_commit(UNet(), str(outside / "ro" / "s.npz"),
                                    9, True, logged.append)
    assert not ok and logged[0].startswith("[snapshot] FAILED at step 9: ")


def test_one_real_run_on_the_cpu(pool, tmp_path, monkeypatch,
                                 default_atom_weights):
    """train_r5 with the port's own train_step in f32: one step (the
    deadline is now), its metrics step, the checkpoint, the float16
    snapshot that loads back, the commit logged, and an EVAL over a
    2-row split at batch 2."""
    monkeypatch.setattr(recipe, "EVAL_BATCH", 2)
    monkeypatch.setattr(recipe, "COMMIT_RETRY_S", 0.0)
    lines = []
    ck, snap = tmp_path / "ck", tmp_path / "snaps" / "s.npz"
    res = tr.train_r5(0.0, 1.0, pool, eval_n=2, batch=2, ckpt_dir=str(ck),
                      snapshot_path=str(snap), device="cpu",
                      dtype="float32", log=lines.append)
    assert res.steps == 1 and res.metrics_steps == 1
    assert res.lr_changes == [(0, 1e-5)] and res.checkpoints == [1]
    assert res.snapshots == [(1, True)]
    assert sorted(os.listdir(ck)) == ["step_00000001.pt"]
    model, step = load_snapshot(str(snap), device="cpu")
    assert step == 1
    assert any(x.startswith("[snapshot] ") for x in lines)
    (step_eval, avg), = res.evals
    assert step_eval == 1 and all(np.isfinite(v) for v in avg.values())
    assert lines[-1] == "RUN COMPLETE"
