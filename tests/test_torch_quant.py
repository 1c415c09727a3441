"""abcnet_tpu_torch.infer.quant (the int8 serving backbone) against
abcnet_tpu.infer.quant on the CPU, 64x64 ink masks, full model width.

  * Folding: the folded float forward against the Flax eval forward on
    the same random-init weights, heads and features within 1e-5 (f32
    convolution order, nothing else).
  * One Q bundle, made by the JAX package (fold, calibrate, quantize),
    through both `forward_quant`s: at every conv site the port's int32
    accumulators equal XLA's s8 x s8 -> s32 convolution of the same int8
    input, bit for bit (transposed convs included); the heads within
    HEAD_ATOL of the JAX int8 heads (the bf16 carry rounds the dequantized
    products in another order, which can flip a site's int8 input by one
    step) and the features' bf16 values within two bf16 steps.
  * The port's own bundle (prepare_quant on a port model) equals the
    JAX one made from the same weights: int8 weights and scales.
  * int_mm pads to cuBLASLt's shapes and stays exact past 2^24.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.infer import quant as jq
from abcnet_tpu.models import create_unet, init_unet
from abcnet_tpu_torch.infer import quant
from abcnet_tpu_torch.models import UNet, from_flax

SIZE = 64
HEAD_ATOL = 0.05
_DN = ("NHWC", "HWIO", "NHWC")


@pytest.fixture(scope="module")
def setup():
    model = create_unet()
    variables = init_unet(jax.random.PRNGKey(0), model,
                          input_shape=(1, SIZE, SIZE, 1))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    x = (np.random.default_rng(1).random((2, SIZE, SIZE, 1)) < 0.1).astype(
        np.float32)
    return model, variables, x


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    if isinstance(tree, float):
        return tree
    return torch.from_numpy(np.array(tree))


def test_fold_matches_flax_eval(setup):
    model, variables, x = setup
    ref_out, ref_y = model.apply(
        variables, jnp.asarray(x), train=False,
        dense_heads=("atom_target", "bond_target"), return_features=True)
    table = quant.fold_eval_params(variables)
    out, y = quant.forward_folded(table, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-5)
    assert sorted(out) == sorted(ref_out)
    for h in ref_out:
        np.testing.assert_allclose(out[h].numpy(), np.asarray(ref_out[h]),
                                   atol=1e-5, err_msg=h)


def test_one_bundle_through_both_forwards(setup):
    _, variables, x = setup
    jtable = jq.fold_eval_params(variables)
    bundle = jq.quantize_folded(jtable, jq.calibrate(jtable, x))
    want_out, want_y = jax.jit(jq.forward_quant)(bundle, jnp.asarray(x))

    rec = {}
    out, y = quant.forward_quant(_to_torch(bundle), torch.from_numpy(x),
                                 rec=rec)
    assert y.dtype == torch.bfloat16 and y.shape == want_y.shape
    sites = [k for k in bundle["scales"] if k not in ("in", "y")]
    sites += [f"y:{h}" for h in bundle["heads"]]
    assert sorted(rec) == sorted(sites)     # every conv site recorded
    layers = {f"{n}.{i}": layer for n in jq._DC_BLOCKS
              for i, layer in enumerate(bundle[n])}
    for n in jq._UPS:
        layers[f"{n}.t"] = bundle[n]["t"]
        layers.update({f"{n}.{i}": layer
                       for i, layer in enumerate(bundle[n]["dc"])})
    layers.update({f"y:{h}": hp["c3"] for h, hp in bundle["heads"].items()})
    for site, (xq, acc) in rec.items():
        kq = layers[site][0]
        xj = jnp.asarray(xq.numpy())
        if site.endswith(".t"):
            want = jax.lax.conv_transpose(
                xj, kq, (2, 2), "VALID", dimension_numbers=_DN,
                preferred_element_type=jnp.int32)
        else:
            want = jax.lax.conv_general_dilated(
                xj, kq, (1, 1), "SAME", dimension_numbers=_DN,
                preferred_element_type=jnp.int32)
        assert acc.dtype == torch.int32
        np.testing.assert_array_equal(acc.numpy(), np.asarray(want),
                                      err_msg=site)
    for h in want_out:
        np.testing.assert_allclose(out[h].numpy(), np.asarray(want_out[h]),
                                   atol=HEAD_ATOL, err_msg=h)
    ulp = np.abs(np.asarray(want_y, np.float32)) * 2.0 ** -7 + 1e-6
    assert np.all(np.abs(y.float().numpy() - np.asarray(want_y, np.float32))
                  <= 2 * ulp)


def test_port_bundle_equals_jax_bundle(setup):
    _, variables, x = setup
    jtable = jq.fold_eval_params(variables)
    want = jq.quantize_folded(jtable, jq.calibrate(jtable, x))
    model = UNet()
    model.load_state_dict(from_flax(variables["params"],
                                    variables["batch_stats"]))
    got = quant.prepare_quant(model.eval(), x)
    for site, s in want["scales"].items():
        assert got["scales"][site] == pytest.approx(s, rel=1e-5), site
    for name in jq._DC_BLOCKS:
        for (kq, sw, b), (jkq, jsw, jb) in zip(got[name], want[name]):
            assert kq.dtype == torch.int8
            diff = np.abs(kq.numpy().astype(int) - np.asarray(jkq, int))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
            np.testing.assert_allclose(sw.numpy(), np.asarray(jsw),
                                       rtol=1e-5)


def test_int_mm_pads_and_stays_exact():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 4609), dtype=np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (4609, 3), dtype=np.int8))
    want = a.long() @ b.long()
    got = quant.int_mm(a, b)
    assert got.dtype == torch.int32 and got.shape == (5, 3)
    assert torch.equal(got.long(), want)
    big = torch.full((20, 4608), 127, dtype=torch.int8)
    assert int(quant.int_mm(big, big.t().contiguous()[:, :8])[0, 0]) == \
        4608 * 127 * 127                    # 74,320,128 > 2^24
