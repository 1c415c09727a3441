"""NMS/top-K of the torch port against abcnet_tpu on the CPU.

The port's plain version (a -inf padded max pool, the mask, a stable
descending sort) must give bit-equal scores and indices to the XLA path
of abcnet_tpu/infer/decode.py on every slot (lax.top_k orders -inf
ties by ascending index too), and to the Pallas kernel in interpret
mode on every finite slot (its exhausted slots repeat index 0, outside
its contract). The cases are those of tests/test_pallas_peaks.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.infer import decode as jax_decode
from abcnet_tpu.ops.pallas_peaks import nms_topk as pallas_nms_topk
from abcnet_tpu.train.metrics import maxpool2d_same
from abcnet_tpu_torch.infer import decode
from abcnet_tpu_torch.ops.peaks import (nms_topk, nms_topk_pair,
                                        nms_topk_plain)
from torch_parity import NMS_CASES, edge_map, plateau_map, random_maps


def _xla(logit, k, threshold):
    pooled = maxpool2d_same(logit[..., None])[..., 0]
    mask = (pooled == logit) & (logit > threshold)
    scores = jnp.where(mask, logit, -jnp.inf).reshape(logit.shape[0], -1)
    return jax.lax.top_k(scores, k)


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_plain_matches_jax(case):
    make, k, thr = NMS_CASES[case]
    m = make()
    ref_s, ref_i = (np.asarray(a) for a in _xla(jnp.asarray(m), k, thr))
    pal_s, pal_i = (np.asarray(a) for a in
                    pallas_nms_topk(jnp.asarray(m), k, thr, interpret=True))
    s, i = nms_topk(torch.from_numpy(m), k, thr)
    assert s.dtype == torch.float32 and i.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), ref_s)
    np.testing.assert_array_equal(i.numpy(), ref_i)       # every slot
    np.testing.assert_array_equal(s.numpy(), pal_s)
    finite = np.isfinite(ref_s)
    np.testing.assert_array_equal(i.numpy()[finite], pal_i[finite])


def test_plateau_and_edge_semantics():
    s, _ = nms_topk(torch.from_numpy(plateau_map()), 8, -1.0)
    assert s[0, 0] == 7.0 and (s[0, 1:5] == 2.0).all()
    assert int(torch.isfinite(s).sum()) == 5
    s, _ = nms_topk(torch.from_numpy(edge_map()), 4, 0.5)
    assert sorted(s[0][torch.isfinite(s[0])].tolist()) == [3.0, 4.0, 5.0]


def test_bf16_input_matches_jax():
    """A bf16 heatmap (the production dtype): JAX compares in bf16, the
    port in f32 after an exact upcast; the threshold -1 is exact in both,
    so peaks and scores agree on every slot."""
    m = random_maps((2, 64, 64))
    jx = jax_decode._topk_logit_peaks(jnp.asarray(m, jnp.bfloat16), 48, -1.0)
    pt = decode._topk_logit_peaks(torch.from_numpy(m).to(torch.bfloat16),
                                  48, -1.0)
    np.testing.assert_array_equal(pt[0].numpy(),
                                  np.asarray(jx[0], np.float32))
    for a, b in zip(pt[1:], jx[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_pair_plain_equals_two_calls():
    """`nms_topk_pair` on CPU tensors is two calls of the plain version,
    each map with its own k; the decode's pair helper gives the fields of
    two single calls."""
    a, b = random_maps((3, 32, 32)), random_maps((3, 32, 32))[:, ::-1].copy()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    (sa, ia), (sb, ib) = nms_topk_pair(ta, 16, tb, 24, -1.0)
    for got, want in ((sa, nms_topk_plain(ta, 16, -1.0)[0]),
                      (ia, nms_topk_plain(ta, 16, -1.0)[1]),
                      (sb, nms_topk_plain(tb, 24, -1.0)[0]),
                      (ib, nms_topk_plain(tb, 24, -1.0)[1])):
        assert torch.equal(got, want)
    assert tuple(sb.shape) == (3, 24) and ib.dtype == torch.int32
    pa, pb = decode._topk_logit_peaks_pair(ta, 16, tb, 24, -1.0)
    for got, want in zip(pa + pb, decode._topk_logit_peaks(ta, 16, -1.0)
                         + decode._topk_logit_peaks(tb, 24, -1.0)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        nms_topk_pair(ta, 16, tb[:, :16], 24, -1.0)
    with pytest.raises(ValueError):
        nms_topk_pair(ta, 16, tb.to(torch.bfloat16), 24, -1.0)
    with pytest.raises(ValueError):
        nms_topk_pair(ta, 16, tb, 32 * 32 + 1, -1.0)


def test_rejects_bad_arguments():
    with pytest.raises(ValueError):
        nms_topk(torch.zeros(4, 4), 2, -1.0)
    with pytest.raises(ValueError):
        nms_topk(torch.zeros(1, 4, 4), 17, -1.0)
