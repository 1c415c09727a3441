"""abcnet_tpu_torch.ops.losses against abcnet_tpu.ops.losses on the CPU.

Both packages get the same numpy logits, labels and `s` vector, in f32.
Tolerance: 1e-5 absolute + 1e-5 relative on every loss term, on the
total, and on the gradient of the total with respect to every logit and
to `s` (f32 sums over up to 2 * 32 * 32 * 360 terms taken in another
order by XLA and PyTorch). Logits are kept off the exact clamp bounds,
where the frameworks' clamp gradients differ by construction.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.data.pipeline import synthetic_batch
from abcnet_tpu.ops import losses as jax_losses
from abcnet_tpu.ops import targets as jax_targets
from abcnet_tpu_torch.models.unet import HEAD_NAMES, PRODUCTION_HEADS
from abcnet_tpu_torch.ops import losses, targets

TOL = dict(rtol=1e-5, atol=1e-5)
GRID = 32
LABEL_KEYS = ("atoms", "n_atoms", "bonds_i", "bonds_f", "n_bonds")


def _inputs(seed, scale):
    rng = np.random.default_rng(seed)
    batch = {k: v for k, v in synthetic_batch(2, seed, GRID * 4).items()
             if k in LABEL_KEYS}
    batch["atoms"][0, :24, 4] = rng.integers(-1, 2, 24)       # some hs labels
    batch["atoms"][:, :24, 3] = rng.integers(0, 3, (2, 24))
    batch["bonds_i"][:, :48, 2] = rng.integers(0, 6, (2, 48))
    # A halo that leaves the grid on the far edge. (On row or column 0 the
    # JAX package wraps the -1 cells; tests/test_torch_targets.py pins that.)
    batch["bonds_i"][0, 0, :2] = (GRID - 1, GRID - 1)
    preds = {n: (rng.normal(size=(2, GRID, GRID, w)) * scale
                 ).astype(np.float32)
             for n, w in zip(HEAD_NAMES, PRODUCTION_HEADS)}
    s = (rng.normal(size=10) / 10).astype(np.float32)
    # Saturated logits whose f32 sigmoid lands exactly on a clamp bound go
    # deeper into the clamped range: at such a tie jnp.clip passes half the
    # gradient and torch.clamp all of it (pinned below).
    for n in ("atom_target", "bond_target", "bond_omega"):
        for p in (np.asarray(jax.nn.sigmoid(jnp.asarray(preds[n]))),
                  torch.sigmoid(torch.from_numpy(preds[n])).numpy()):
            tie = (p == np.float32(losses.EPS_CLAMP)) | \
                (p == np.float32(1.0 - losses.EPS_CLAMP))
            preds[n][tie] *= 1.05
    return batch, preds, s


def _jax_total(preds, s, batch, fused):
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    t = jax_targets.build_targets(b, with_full_type=not fused, grid=GRID)
    terms = jax_losses.compute_losses(preds, t, b, fused_bond_type=fused)
    return jax_losses.total_loss(terms, s), terms


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 4.0)])
def test_losses_and_gradients_match_jax(seed, scale, fused):
    batch, preds, s = _inputs(seed, scale)
    (want_total, want_terms), want_grads = jax.value_and_grad(
        _jax_total, argnums=(0, 1), has_aux=True)(
            {k: jnp.asarray(v) for k, v in preds.items()}, jnp.asarray(s),
            batch, fused)

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in preds.items()}
    ts = torch.from_numpy(s).requires_grad_()
    t = targets.build_targets(tb, with_full_type=not fused, grid=GRID)
    terms = losses.compute_losses(tp, t, tb, fused_bond_type=fused)
    total = losses.total_loss(terms, ts)
    total.backward()

    assert sorted(terms) == sorted(want_terms) == sorted(losses.S_INDEX)
    for k in want_terms:
        np.testing.assert_allclose(float(terms[k]), float(want_terms[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(float(total), float(want_total), **TOL)
    for k in preds:
        np.testing.assert_allclose(tp[k].grad.numpy(),
                                   np.asarray(want_grads[0][k]), err_msg=k,
                                   **TOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want_grads[1]),
                               **TOL)


def test_clamp_tie_gradient_divergence_is_the_frameworks():
    """Exactly on a clamp bound the two frameworks differentiate the clamp
    differently (JAX halves the gradient, torch passes it); one ulp inside
    they agree. Nothing in either package chooses this."""
    hi = np.float32(1.0 - losses.EPS_CLAMP)
    inside = np.nextafter(hi, np.float32(0))
    for p, want_jax, want_torch in ((hi, 0.5, 1.0), (inside, 1.0, 1.0)):
        assert float(jax.grad(lambda v: jax_losses._clamp(v))(
            jnp.float32(p))) == want_jax
        t = torch.tensor(p, requires_grad=True)
        losses._clamp(t).backward()
        assert float(t.grad) == want_torch


def test_bf16_logits_are_upcast_in_the_loss():
    batch, preds, s = _inputs(2, 1.0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    t = targets.build_targets(tb, grid=GRID)
    bf = {k: torch.from_numpy(v).bfloat16() for k, v in preds.items()}
    terms = losses.compute_losses(bf, t, tb)
    same = losses.compute_losses({k: v.float() for k, v in bf.items()}, t, tb)
    for k in terms:
        assert terms[k].dtype == torch.float32
        assert float(terms[k]) == float(same[k]), k


def test_activations_builds_only_what_is_asked():
    _, preds, _ = _inputs(3, 1.0)
    tp = {k: torch.from_numpy(v) for k, v in preds.items()}
    act = losses.activations(tp, ["atom_target", "bond_rho"])
    assert sorted(act) == ["atom_target", "bond_rho"]
    full = losses.activations(tp)
    want = jax_losses.activations({k: jnp.asarray(v)
                                   for k, v in preds.items()})
    assert sorted(full) == sorted(want)
    for k in want:
        np.testing.assert_allclose(full[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, rtol=1e-5, atol=1e-6)


def test_empty_labels_give_finite_losses():
    batch, preds, s = _inputs(4, 1.0)
    batch["n_atoms"][:] = 0
    batch["n_bonds"][:] = 0
    want_total, _ = _jax_total({k: jnp.asarray(v) for k, v in preds.items()},
                               jnp.asarray(s), batch, True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    terms = losses.compute_losses(
        {k: torch.from_numpy(v) for k, v in preds.items()},
        targets.build_targets(tb, grid=GRID), tb)
    total = losses.total_loss(terms, torch.from_numpy(s))
    assert np.isfinite(float(total))
    np.testing.assert_allclose(float(total), float(want_total), **TOL)


def test_set_atom_type_weights():
    batch, preds, _ = _inputs(5, 1.0)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp = {k: torch.from_numpy(v) for k, v in preds.items()}
    t = targets.build_targets(tb, grid=GRID)
    before = float(losses.compute_losses(tp, t, tb)["atom_type"])
    default = losses._ATOM_W.copy()
    try:
        losses.set_atom_type_weights(np.ones(14, np.float32))
        assert float(losses.compute_losses(tp, t, tb)["atom_type"]) != before
        with pytest.raises(ValueError):
            losses.set_atom_type_weights(np.ones(3))
    finally:
        losses.set_atom_type_weights(default)
    assert float(losses.compute_losses(tp, t, tb)["atom_type"]) == before
