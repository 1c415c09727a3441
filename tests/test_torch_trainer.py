"""abcnet_tpu_torch.train.trainer against abcnet_tpu.train.trainer on the CPU.

Small sizes: 128 x 128 inputs (grid 32), batch 4, full model width, f32.
Both packages start from the same Flax init (mapped by from_flax) and
get the same numpy batch.

"One step matches" is tested in two parts, because the first Adam
update is lr * sign(g) wherever |g| >> eps: two frameworks whose
gradients differ by 1e-6 near zero then give parameters that differ by
2 * lr, whatever the code does.

  * Losses and parameter gradients of one forward/backward against
    jax.value_and_grad(loss_and_metrics), in eval mode and in train mode
    (batch-stat BN), on the step-43100 snapshot weights and drawing-like
    input (6% ink). Dropout and input noise draw from framework RNGs
    that cannot be matched, so both are switched off for this one
    comparison: amount 0, flax.linen.Dropout patched to the identity,
    the port's drop rate set to 0. Tolerance: total and terms relative
    1e-4. Gradients by the relative L2 error of each leaf, GRAD_RTOL:
    2e-3 in eval mode and 8e-2 in train mode. The train-mode figure is
    the f32 noise floor, not slack: the backward of a batch-stat BN
    subtracts the gradient's mean and its component along the
    normalized activation, and what is left is small against the terms
    that cancel. Held against a float64 run of the port, the f32
    gradients of both packages lie 2e-3 to 2.5e-2 away on this input
    (4e-2 to 7e-2 from a random init, which is why the trained weights
    are used), and a 1e-7 relative change of the weights moves them by
    as much. A fault in the plumbing (BN statistics left out of the
    backward, a missing term, a wrong sign) shows at order 1. Leaves
    whose analytic gradient is zero (a conv bias that feeds a batch-stat
    BN) hold rounding residue only and are held to the scale of the
    whole tree instead.
  * BN running statistics after that train forward against Flax's
    mutated batch_stats, 1e-5 (+1e-4 relative; the batch means of f32
    convolution outputs differ by that much between the frameworks): pins
    the biased-variance update, which at the bottleneck's 64 values per
    channel is 1.6e-3 away from torch's own.
  * The optimizer on identical numpy gradients over 5 steps, the LR drop
    included, against the optax chain of abcnet_tpu's make_optimizer,
    1e-6.

Then the trainer's own plumbing: micro-batch accumulation against an
unrolled computation, steps that lower the loss, the paired metrics step
seeing the train step's images, checkpoints, weights through the npz
snapshot into the JAX package, and the `train` CLI.
"""

import copy
import random
from unittest import mock

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.data.pipeline import synthetic_batch
from abcnet_tpu.models.unet import UNet as FlaxUNet
from abcnet_tpu.train import trainer as jax_trainer
from abcnet_tpu_torch import __main__ as cli
from abcnet_tpu_torch.data import pipeline, raster
from abcnet_tpu_torch.models import UNet, from_flax
from abcnet_tpu_torch.models.unet import OutConv
from abcnet_tpu_torch.models.weights import (load_snapshot, save_snapshot,
                                             to_flax)
from abcnet_tpu_torch.train import trainer
from torch_parity import fixture_samples, flax_variables, ink_images

SIZE = 128
BATCH = 4
GRAD_RTOL = {False: 2e-3, True: 8e-2}     # eval, train: see above


@pytest.fixture(scope="module")
def flax_init():
    return flax_variables(3, SIZE)


@pytest.fixture(scope="module")
def host_batch():
    return synthetic_batch(BATCH, seed=0, size=SIZE)


def port_state(flax_init, **cfg_kw):
    cfg = trainer.TrainConfig(dtype="float32", device="cpu", batch_size=BATCH,
                              **cfg_kw)
    model = UNet(dtype=torch.float32)
    model.load_state_dict(from_flax(*flax_init))
    return cfg, trainer.create_state(cfg, model)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_loss_and_grads(flax_init, batch, train):
    params, stats = flax_init
    apply_fn = FlaxUNet(dtype=jnp.float32).apply
    fn = jax.value_and_grad(jax_trainer.loss_and_metrics, has_aux=True)
    identity = lambda self, inputs, *a, **k: inputs  # noqa: E731
    with mock.patch.object(flax.linen.Dropout, "__call__", identity):
        (total, aux), grads = fn(params, stats, apply_fn,
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 jax.random.PRNGKey(0), 0.0, train, False)
    return float(total), aux, grads


@pytest.fixture(scope="module")
def snapshot_init():
    return flax_variables("snapshot", SIZE)


@pytest.fixture(scope="module")
def drawing_batch(host_batch):
    """The synthetic labels with drawing-like images: 6% ink."""
    bits = np.packbits(ink_images(BATCH, SIZE, seed=0)[..., 0] > 0, axis=-1)
    return {**host_batch, "image_bits": bits}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_loss_gradients_and_bn_stats_match_jax(snapshot_init, drawing_batch,
                                               train, monkeypatch):
    flax_init, host_batch = snapshot_init, drawing_batch
    want_total, want_aux, want_grads = _jax_loss_and_grads(flax_init,
                                                           host_batch, train)
    monkeypatch.setattr(OutConv, "DROP", 0.0)       # keep mask of ones
    _, state = port_state(flax_init)
    batch = trainer.to_device(host_batch, "cpu")
    total, aux = trainer.loss_and_metrics(
        state.model, batch, torch.Generator().manual_seed(0), amount=0.0,
        train=train, with_metrics=False)
    total.backward()

    np.testing.assert_allclose(float(total), want_total, rtol=1e-4)
    for k, v in want_aux["losses"].items():
        np.testing.assert_allclose(float(aux["losses"][k]), float(v),
                                   rtol=1e-4, atol=1e-6, err_msg=k)

    got = _flat(to_flax({n: p.grad for n, p in
                         state.model.named_parameters()})[0])
    want = _flat(want_grads)
    assert sorted(got) == sorted(want)
    norms = {k: float(np.linalg.norm(v)) for k, v in want.items()}
    top = max(norms.values())
    for k in want:
        err = float(np.linalg.norm(got[k] - want[k]))
        if norms[k] > 1e-3 * top:
            assert err <= GRAD_RTOL[train] * norms[k], (k, err / norms[k])
        else:
            assert err <= 1e-3 * top, (k, err, top)

    got_stats = _flat(to_flax(state.model.state_dict())[1])
    want_stats = _flat(want_aux["batch_stats"])
    before = _flat(flax_init[1])
    assert sorted(got_stats) == sorted(want_stats)
    moved = 0
    for k in want_stats:
        np.testing.assert_allclose(got_stats[k], want_stats[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        moved += not np.array_equal(got_stats[k], before[k])
    assert moved == (len(want_stats) if train else 0)
    if train:
        # The bottleneck sees n = 4 * 4 * 4 values per channel: torch's own
        # update (unbiased variance, n / (n - 1) larger) would sit 1.6e-3
        # relative away, sixteen times the tolerance above.
        k, n = "down5/DoubleConv_0/BatchNorm_1/var", BATCH * 4 * 4
        unbiased = 0.9 * before[k] + (want_stats[k] - 0.9 * before[k]) \
            * n / (n - 1)
        assert np.abs(got_stats[k] - want_stats[k]).max() < \
            0.05 * np.abs(unbiased - want_stats[k]).max()


def test_optimizer_trajectory_matches_optax_with_lr_drop():
    """Identical numpy gradients into both optimizers for 5 steps, the LR
    dropped to a tenth before step 3: parameters within 1e-6."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (11,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    # gradients of mixed size, some near zero, some exactly zero
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-6, 1, size=s)
                  * (rng.random(s) > 0.1)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]

    jcfg = jax_trainer.TrainConfig()
    tx = jax_trainer.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jax_trainer.TrainState(step=jnp.zeros((), jnp.int32),
                                    params=jparams, batch_stats={},
                                    opt_state=tx.init(jparams), tx=tx,
                                    apply_fn=None)

    cfg = trainer.TrainConfig(device="cpu")
    assert (cfg.lr, cfg.weight_decay, cfg.lr_drop_factor, cfg.lr_drop_epoch) \
        == (jcfg.lr, jcfg.weight_decay, jcfg.lr_drop_factor,
            jcfg.lr_drop_epoch)
    holder = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in p0.items()})
    state = trainer.TrainState(model=holder,
                               optimizer=trainer.make_optimizer(cfg, holder),
                               step=0, generator=torch.Generator())
    for i, g in enumerate(grads):
        if i == 3:
            lr = cfg.lr * cfg.lr_drop_factor
            jstate = jax_trainer.set_learning_rate(jstate, lr)
            trainer.set_learning_rate(state, lr)
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate.opt_state,
            jstate.params)
        jstate = jstate.replace(
            params=jax.tree_util.tree_map(jnp.add, jstate.params, updates),
            opt_state=opt_state)
        for k, v in g.items():
            holder[k].grad = torch.from_numpy(v.copy())
        state.optimizer.step()
        for k in shapes:
            np.testing.assert_allclose(holder[k].detach().numpy(),
                                       np.asarray(jstate.params[k]), rtol=0,
                                       atol=1e-6, err_msg=f"step {i} {k}")
    moved = np.abs(holder["a"].detach().numpy() - p0["a"]).max()
    assert cfg.lr < moved < 3.2 * cfg.lr    # at most 3 full-LR steps + 2 small


def test_train_step_scan_matches_unrolled(flax_init, host_batch):
    """train_step_scan against the same computation written out: the
    interleaved split (rows 0, 2 then 1, 3), one generator stream across
    the micro-batches, BN statistics carried from one to the next, the
    mean of the two gradients. On SGD(1.0), params_after - params_before
    is minus that mean, so the comparison is of the accumulation and not
    of Adam's sign(g) step. Noise and dropout are on."""
    _, s1 = port_state(flax_init)
    s1.optimizer = torch.optim.SGD(s1.model.parameters(), lr=1.0)
    s2 = copy.deepcopy(s1)
    batch = trainer.to_device(host_batch, "cpu")
    p0 = {n: p.detach().clone() for n, p in s1.model.named_parameters()}

    s1, total, losses, mets = trainer.train_step_scan(s1, batch, rng=7,
                                                      n_micro=2)
    assert s1.step == 1 and mets == {}

    gen = torch.Generator().manual_seed(7)
    gsum = {n: torch.zeros_like(p) for n, p in p0.items()}
    tsum = 0.0
    for rows in ([0, 2], [1, 3]):
        mb = {k: v[rows] for k, v in batch.items()}
        s2.model.zero_grad(set_to_none=True)
        t, aux = trainer.loss_and_metrics(s2.model, mb, gen, 0.2, True, False)
        t.backward()
        for n, p in s2.model.named_parameters():
            gsum[n] += p.grad
        tsum += float(t)
    np.testing.assert_allclose(float(total), tsum / 2, rtol=1e-6)
    assert sorted(losses) == sorted(aux["losses"])
    for n, p in s1.model.named_parameters():
        torch.testing.assert_close(p.detach(), p0[n] - gsum[n] / 2,
                                   rtol=1e-5, atol=1e-6, msg=n)
    for (n, a), (_, b) in zip(s1.model.named_buffers(),
                              s2.model.named_buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    with pytest.raises(RuntimeError):
        trainer.train_step_scan(s1, batch, rng=7, n_micro=3)   # 4 % 3 != 0


def test_four_train_steps_lower_the_loss(flax_init, host_batch):
    cfg, state = port_state(flax_init)
    batch = trainer.to_device(host_batch, "cpu")
    totals = []
    for _ in range(4):
        state, total, losses, mets = trainer.train_step(state, batch,
                                                        amount=cfg.amount)
        totals.append(float(total))
    assert all(np.isfinite(t) for t in totals)
    assert totals[-1] < totals[0]
    assert state.step == 4
    assert sorted(losses) == sorted(trainer.L.S_INDEX)
    assert "bond_types_acc" not in mets and "atom_target_precision" in mets
    assert all(not v.requires_grad for v in losses.values())
    assert state.model.training


def test_eval_step_and_evaluate(flax_init, host_batch):
    cfg, state = port_state(flax_init, eval_batch_size=2)
    total, losses, mets = trainer.eval_step(
        state, trainer.to_device(host_batch, "cpu"))
    assert np.isfinite(float(total)) and not state.model.training
    assert "bond_types_acc" in mets                 # dense eval-only metric
    assert all(bool(torch.isfinite(n)) for n, _ in mets.values())
    # a uint8 batch takes the device_preprocess route to the same images
    ink = np.unpackbits(host_batch["image_bits"], axis=-1).astype(bool)
    u8 = {k: v for k, v in host_batch.items() if k != "image_bits"}
    u8["image_u8"] = np.where(ink, 0, 255).astype(np.uint8)
    assert float(trainer.eval_step(state, trainer.to_device(u8, "cpu"))[0]) \
        == float(total)
    rng = random.Random(0)
    examples = [pipeline.sample_to_example(s, rng, train=False)
                for s in fixture_samples(range(5))]
    out = trainer.evaluate(state, examples, cfg, verbose=False)
    assert np.isfinite(out["loss"]) and "atom_true_per_img" in out
    preds = trainer.predict_step(state, torch.from_numpy(
        ink_images(1, 64, seed=1)))
    assert tuple(preds["bond_type"].shape) == (1, 16, 16, 360)


def test_metrics_step_sees_the_train_step_images(flax_init, host_batch,
                                                 monkeypatch):
    """The same per-step rng gives train_metrics_step the very images its
    paired train_step saw (the noise stream is a function of rates and
    seed), and another rng gives others."""
    _, state = port_state(flax_init)
    batch = trainer.to_device(host_batch, "cpu")
    seen = []
    real = pipeline.device_unpack_bits
    monkeypatch.setattr(pipeline, "device_unpack_bits",
                        lambda *a, **k: (seen.append(real(*a, **k)),
                                         seen[-1])[1])
    trainer.train_step(state, batch, rng=11, with_metrics=False)
    mets = trainer.train_metrics_step(state, batch, rng=11)
    trainer.train_metrics_step(state, batch, rng=12)
    assert torch.equal(seen[0], seen[1])
    assert not torch.equal(seen[0], seen[2])
    assert not torch.equal(seen[0], real(batch["image_bits"]))    # noisy
    assert not state.model.training and "bond_types_acc" not in mets
    # without an rng the state's generator supplies one: two states from
    # one seed draw the same sequence
    _, other = port_state(flax_init)
    assert [trainer.next_rng(state) for _ in range(3)] == \
        [trainer.next_rng(other) for _ in range(3)]


def test_checkpoint_roundtrip_restores_moments_lr_and_generator(
        flax_init, host_batch, tmp_path):
    cfg, state = port_state(flax_init)
    batch = trainer.to_device(host_batch, "cpu")
    for _ in range(2):                                  # non-trivial moments
        trainer.train_step(state, batch, with_metrics=False)
    trainer.set_learning_rate(state, 1.25e-5)
    trainer.save_checkpoint(state, str(tmp_path / "old"), step=1)
    path = trainer.save_checkpoint(state, str(tmp_path))
    assert path.endswith("step_00000002.pt")

    restored = trainer.restore_checkpoint(trainer.create_state(cfg),
                                          str(tmp_path))
    assert restored.step == 2
    assert restored.optimizer.param_groups[0]["lr"] == 1.25e-5
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              restored.model.state_dict().items()):
        assert torch.equal(a, b), n
    sa, sb = state.optimizer.state_dict(), restored.optimizer.state_dict()
    assert sorted(sa["state"]) == sorted(sb["state"])
    for i in sa["state"]:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    assert trainer.next_rng(restored) == trainer.next_rng(state)
    # the resumed step is the step the original takes
    r1 = trainer.train_step(state, batch, rng=5, with_metrics=False)[1]
    r2 = trainer.train_step(restored, batch, rng=5, with_metrics=False)[1]
    assert float(r1) == float(r2)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        trainer.restore_checkpoint(state, str(tmp_path / "empty"))


def test_weights_move_both_ways(flax_init, tmp_path):
    params, stats = flax_init
    back_p, back_s = to_flax(from_flax(params, stats))
    want, got = _flat({"p": params, "s": stats}), \
        _flat({"p": back_p, "s": back_s})
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    # a model trained a little in the port, exported, read by the JAX side
    cfg, state = port_state(flax_init)
    trainer.train_step(state, trainer.to_device(
        synthetic_batch(2, seed=1, size=SIZE), "cpu"), with_metrics=False)
    path = save_snapshot(state.model, str(tmp_path / "port.npz"),
                         step=state.step)
    z = np.load(path)
    assert int(z["__step__"]) == 1
    assert all(k == "__step__" or k.startswith(("params/", "batch_stats/"))
               for k in z.files)
    assert all(z[k].dtype == np.float32 for k in z.files if k != "__step__")
    jp, js = flax_variables(path, SIZE)
    x = ink_images(2, SIZE, seed=6)
    want_heads = FlaxUNet(dtype=jnp.float32).apply(
        {"params": jp, "batch_stats": js}, x, train=False)
    state.model.eval()
    with torch.no_grad():
        got_heads = state.model(torch.from_numpy(x))
    for k in want_heads:
        np.testing.assert_allclose(got_heads[k].numpy(),
                                   np.asarray(want_heads[k]), rtol=0,
                                   atol=1e-4, err_msg=k)
    loaded, step = load_snapshot(path, device="cpu", dtype=torch.float32)
    assert step == 1
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              loaded.state_dict().items()):
        if not n.endswith("num_batches_tracked"):
            assert torch.equal(a, b), n


def test_create_state_is_seeded_and_single_device():
    cfg = trainer.TrainConfig(heads=(1, 2), dtype="float32", device="cpu",
                              seed=4)
    before = torch.random.get_rng_state()
    a, b = trainer.create_state(cfg), trainer.create_state(cfg)
    assert torch.equal(torch.random.get_rng_state(), before)
    for (n, p), (_, q) in zip(a.model.named_parameters(),
                              b.model.named_parameters()):
        assert torch.equal(p, q), n
    assert a.optimizer.defaults["weight_decay"] == 1e-8
    assert a.optimizer.defaults["eps"] == 1e-8
    # more than one device needs a process group (tests/test_torch_parallel)
    with pytest.raises(RuntimeError, match="data-parallel"):
        trainer.create_state(trainer.TrainConfig(device="cpu", n_devices=2))


def _write_dataset(root, samples):
    rows = ["Smiles,atoms_string,bonds_string,path"]
    for i, s in enumerate(samples):
        raster.imwrite(str(root / f"{i}.png"), s.image)
        rows.append(f'{s.smiles},"{s.atoms_string}","{s.bonds_string}",'
                    f"{i}.png")
    (root / "dataset.csv").write_text("\n".join(rows) + "\n")


def test_fit_resumes_and_drops_the_lr(flax_init, tmp_path):
    """fit over raw samples (re-augmented every epoch) and pre-built
    examples, with a checkpoint per epoch; a resumed fit continues at the
    saved step with the dropped LR."""
    samples = fixture_samples(range(4))
    cfg, state = port_state(flax_init, epochs=3, ckpt_dir=str(tmp_path),
                            metrics_every=2, log_every=1, eval_every=2)
    cfg.batch_size = 2
    rng = random.Random(0)
    test = [pipeline.sample_to_example(s, rng, train=False)
            for s in samples[:2]]
    cfg.eval_batch_size = 2
    state = trainer.fit(cfg, samples, test, state=state, verbose=False)
    assert state.step == 6                      # 3 epochs x 2 batches
    assert state.optimizer.param_groups[0]["lr"] == \
        pytest.approx(cfg.lr * cfg.lr_drop_factor)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000002.pt", "step_00000004.pt", "step_00000006.pt"]
    resumed = trainer.restore_checkpoint(trainer.create_state(cfg),
                                         str(tmp_path), step=4)
    examples = [pipeline.sample_to_example(s, rng, train=True)
                for s in samples]
    resumed = trainer.fit(cfg, examples, None, state=resumed, verbose=False)
    assert resumed.step == 6                    # epoch 2 of 3 only
    assert resumed.optimizer.param_groups[0]["lr"] == \
        pytest.approx(cfg.lr * cfg.lr_drop_factor)


def test_cli_train_two_steps_on_a_csv_dataset(tmp_path, capsys):
    data = tmp_path / "ds"
    data.mkdir()
    _write_dataset(data, fixture_samples((0, 1, 40, 41)))
    ckpt = tmp_path / "ckpt"
    cli.main(["train", "--data", str(data), "-b", "2", "--epochs", "1",
              "--no-test-split", "--dtype", "float32", "--device", "cpu",
              "--ckpt", str(ckpt), "--seed", "1"])
    out = capsys.readouterr().out
    assert "training on 4 samples, eval on 0" in out
    assert [p.name for p in ckpt.iterdir()] == ["step_00000002.pt"]
    cli.main(["train", "--data", str(data), "-b", "2", "--epochs", "1",
              "--dtype", "float32", "--device", "cpu", "--resume", str(ckpt)])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert "training on 3 samples, eval on 1" in out
    # without --data the CLI trains on --synthetic N generated samples
    cli.main(["train", "--synthetic", "2", "-b", "2", "--epochs", "1",
              "--no-test-split", "--dtype", "float32", "--device", "cpu",
              "--ckpt", str(tmp_path / "synthetic")])
    assert "training on 2 samples, eval on 0" in capsys.readouterr().out
    assert [p.name for p in (tmp_path / "synthetic").iterdir()] == \
        ["step_00000001.pt"]
    with pytest.raises(SystemExit, match="dataset csv not found"):
        cli.main(["train", "--data", str(tmp_path / "none"), "--device",
                  "cpu"])
