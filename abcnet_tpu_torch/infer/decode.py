"""Batched on-device peak extraction: heatmaps -> compact peak arrays.

Counterpart of abcnet_tpu/infer/decode.py, with the same outputs (keys,
shapes, dtypes) and the same semantics:

  * 3x3 max-pool NMS on the atom/bond heatmaps at logit threshold -1,
    then the top K cells (kernel 2, ops/peaks.py, on the GPU);
  * class/charge/hs argmax at the atom peaks;
  * circular 1-D NMS over the 60 omega bins at the bond peaks, halo and
    antipodal suppression, up to OMEGA_PER_BOND bins per peak;
  * rho and the 6-way bond type at the surviving bins; delta = rho *
    (cos w, sin w) with w = bin*pi/30 + pi/60 - pi/2;
  * parabolic sub-cell offsets at every peak.

Two head-evaluation strategies feed the same tail: dense
(`extract_peaks`, every head map materialized) and sparse
(`extract_peaks_sparse`, the default for serving: only the two heatmap
heads run densely, the six wide heads are evaluated at the peak cells
from gathered 3x3 trunk-feature windows).

Ties: `lax.top_k` orders ties by ascending index and `torch.topk`
promises no order, so every top-K here is a stable descending sort.
Coordinates are (row, col) = (idx // G, idx % G).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..data import vocab
from ..data.pipeline import device_unpack_bits, pack_images
from ..ops.peaks import nms_topk, nms_topk_pair
from ..parallel.mesh import replicate_tree
from ..utils import profiling
from ..utils.device import resolve_device

NO = vocab.NUM_OMEGA_BINS
NB = vocab.NUM_BOND_CLASSES

MAX_ATOM_PEAKS = 128
MAX_BOND_PEAKS = 160
OMEGA_PER_BOND = 4

NEG_INF = float("-inf")


@dataclass(frozen=True)
class DecodeConfig:
    max_atoms: int = MAX_ATOM_PEAKS
    max_bonds: int = MAX_BOND_PEAKS
    omega_per_bond: int = OMEGA_PER_BOND
    # NMS threshold on logits (the reference's img2smiles2.py:64, > -1).
    logit_threshold: float = -1.0
    # Cross-cell omega halo suppression margin (logits): a bin dies if a
    # (cell +-1, bin +-1) neighbour beats it by more than this. <= 0
    # disables the filter.
    halo_margin: float = 1.0
    # Parabolic sub-cell peak refinement (atom_sub / bond_sub offsets,
    # consumed by the host matcher).
    subcell: bool = True


def _stable_topk(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: descending, ties by ascending index."""
    top, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return top[..., :k], idx[..., :k]


def _peak_fields(top: torch.Tensor, idx: torch.Tensor, width: int):
    idx = idx.long()
    return top, idx // width, idx % width, torch.isfinite(top)


def _topk_logit_peaks(logit: torch.Tensor, k: int, threshold: float):
    """logit: (B, G, G). Returns (score, x, y, valid), each (B, k); score
    is f32, x/y int64 (row, col)."""
    return _peak_fields(*nms_topk(logit, k, threshold), logit.shape[-1])


def _topk_logit_peaks_pair(a_logit: torch.Tensor, k_a: int,
                           b_logit: torch.Tensor, k_b: int,
                           threshold: float):
    """`_topk_logit_peaks` of the atom and the bond heatmap, through one
    kernel launch on the GPU."""
    a, b = nms_topk_pair(a_logit, k_a, b_logit, k_b, threshold)
    return (_peak_fields(*a, a_logit.shape[-1]),
            _peak_fields(*b, b_logit.shape[-1]))


def _antipodal_keep(w: torch.Tensor) -> torch.Tensor:
    """Antipodal suppression (the reference's img2smiles2.py:139-158).

    w: (..., 60) omega scores. Bin i survives unless dominated by the
    opposite-direction window (bins i+29..i+31, circular): a strict `<`
    drop test for bins <= 29 and `<=` for bins >= 30, so exact ties keep
    the lower-direction bin only."""
    idx = torch.arange(NO, device=w.device)
    opp = torch.stack([(idx + 29) % NO, (idx + 30) % NO, (idx + 31) % NO])
    opp_max = w[..., opp].amax(dim=-2)
    return torch.where(idx < 30, w >= opp_max, w > opp_max)


def subcell_offsets(logit: torch.Tensor, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """Per-axis parabolic sub-cell refinement at integer peak cells.

    logit: (B, G, G); xs, ys: (B, K). A 1-D parabola through (left,
    centre, right) on each axis gives (B, K, 2) f32 offsets clipped to
    +-0.49; border cells clamp to the edge value."""
    g = logit.shape[-1]
    b_idx = torch.arange(logit.shape[0], device=logit.device)[:, None]

    def at(r, c):
        return logit[b_idx, r, c].float()

    def axis_off(lo, c, hi):
        denom = 2.0 * c - lo - hi
        return torch.clamp(0.5 * (hi - lo) / torch.clamp(denom, min=1e-6),
                           -0.49, 0.49)

    c = at(xs, ys)
    lx, hx = at((xs - 1).clamp(min=0), ys), at((xs + 1).clamp(max=g - 1), ys)
    ly, hy = at(xs, (ys - 1).clamp(min=0)), at(xs, (ys + 1).clamp(max=g - 1))
    return torch.stack([axis_off(lx, c, hx), axis_off(ly, c, hy)], dim=-1)


def _circular_max3(w: torch.Tensor) -> torch.Tensor:
    """Max over bins (i-1, i, i+1), circular, along the last axis."""
    p = torch.cat([w[..., -1:], w, w[..., :1]], dim=-1)
    return torch.maximum(torch.maximum(p[..., :-2], p[..., 1:-1]),
                         p[..., 2:])


def _decode_bonds(w, neigh_max, bt_at_peak, rho60, bx, by, b_valid, cfg,
                  bsub=None) -> Dict[str, torch.Tensor]:
    """Shared bond decode tail. All inputs are per-peak gathers:

      w          (B, Kb, 60)    f32 omega logits at bond peaks
      neigh_max  (B, Kb, 60)    max over the 9-cell/3-bin halo window,
                                or None to disable halo suppression
      bt_at_peak (B, Kb, 6, 60) bond-type logits at peaks
      rho60      (B, Kb, 60)    rho head at peaks
    """
    local_max = (_circular_max3(w) == w) & (w > cfg.logit_threshold)
    keep = local_max & _antipodal_keep(w)
    if neigh_max is not None:
        keep = keep & (w >= neigh_max - cfg.halo_margin)

    w_masked = torch.where(keep, w, NEG_INF)
    o_raw, o_bin = _stable_topk(w_masked, cfg.omega_per_bond)
    o_valid = torch.isfinite(o_raw)                     # (B, Kb, M)
    o_score = torch.where(o_valid, torch.sigmoid(o_raw),
                          torch.zeros((), device=w.device))

    bsz, kb, m = o_bin.shape
    bt_at_bin = torch.gather(bt_at_peak, -1,
                             o_bin[:, :, None, :].expand(bsz, kb, NB, m))
    btype = bt_at_bin.float().argmax(dim=2)             # (B, Kb, M)
    rho = torch.gather(rho60, -1, o_bin).abs().float()

    ang = o_bin * (math.pi / 30) + math.pi / 60 - math.pi / 2
    dx = rho * torch.cos(ang)
    dy = rho * torch.sin(ang)

    def flat(t):
        return t.reshape(bsz, kb * m, *t.shape[3:])

    bond_xy = torch.stack([bx, by], dim=-1)[:, :, None, :].expand(
        bsz, kb, m, 2)
    out = {
        "bond_score": flat(o_score),
        "bond_xy": flat(bond_xy).to(torch.int32),
        "bond_delta": flat(torch.stack([dx, dy], dim=-1)),
        "bond_type": flat(btype).to(torch.int32),
        "bond_valid": flat(o_valid & b_valid[..., None]),
    }
    if bsub is not None:
        out["bond_sub"] = flat(bsub[:, :, None, :].expand(bsz, kb, m, 2))
    return out


def _atom_outputs(a_raw, ax, ay, a_valid, atom_type, atom_charge, atom_hs,
                  asub=None) -> Dict[str, torch.Tensor]:
    out = {
        "atom_score": torch.sigmoid(a_raw.float()),
        "atom_xy": torch.stack([ax, ay], dim=-1).to(torch.int32),
        "atom_type": atom_type.to(torch.int32),
        "atom_charge": atom_charge.to(torch.int32),
        "atom_hs": atom_hs.to(torch.int32),
        "atom_valid": a_valid,
    }
    if asub is not None:
        out["atom_sub"] = asub
    return out


@torch.no_grad()
def extract_peaks(preds: Dict[str, torch.Tensor],
                  cfg: DecodeConfig = DecodeConfig()
                  ) -> Dict[str, torch.Tensor]:
    """Dense-head path. preds: NHWC logits from the model (all heads).
    Returns compact peak arrays:

      atom_score   (B, Ka)      atom_xy     (B, Ka, 2)   int32
      atom_type    (B, Ka)      atom_charge (B, Ka)      atom_hs (B, Ka)
      atom_valid   (B, Ka)      bool
      bond_score   (B, Kb*M)    bond_xy     (B, Kb*M, 2)
      bond_delta   (B, Kb*M, 2) float32 (dx, dy in grid units)
      bond_type    (B, Kb*M)    int32 (0..5)
      bond_valid   (B, Kb*M)    bool
      atom_sub / bond_sub       float32 sub-cell offsets (cfg.subcell)

    NMS, threshold and argmax work on raw logits (sigmoid and softmax are
    monotonic); the gathered class vectors are argmaxed at the peaks."""
    thr = cfg.logit_threshold
    a_logit = preds["atom_target"][..., 0]
    b_logit = preds["bond_target"][..., 0]
    (a_raw, ax, ay, a_valid), (_, bx, by, b_valid) = _topk_logit_peaks_pair(
        a_logit, cfg.max_atoms, b_logit, cfg.max_bonds, thr)
    b_idx = torch.arange(a_logit.shape[0], device=a_logit.device)[:, None]
    atom_type = preds["atom_type"][b_idx, ax, ay].argmax(-1)
    atom_charge = preds["atom_charge"][b_idx, ax, ay].argmax(-1)
    atom_hs = preds["atom_hs"][b_idx, ax, ay].argmax(-1)

    omega = preds["bond_omega"]
    w = omega[b_idx, bx, by].float()

    neigh_max = None
    if cfg.halo_margin > 0:
        # The dense path clips out-of-map neighbours to the edge cell
        # (the sparse path masks them to -inf; both as in the JAX
        # package, decode.py:442-448).
        g = b_logit.shape[1]
        di = torch.arange(-1, 2, device=bx.device)
        nx = (bx[..., None, None] + di[:, None]).clamp(0, g - 1)
        ny = (by[..., None, None] + di[None, :]).clamp(0, g - 1)
        w9 = omega[b_idx[..., None, None], nx, ny].float()
        w9 = w9.reshape(w.shape[0], w.shape[1], 9, NO)
        neigh_max = _circular_max3(w9).amax(dim=2)

    bt = preds["bond_type"]
    bt_at_peak = bt[b_idx, bx, by].reshape(*bx.shape, NB, NO)
    rho60 = preds["bond_rho"][b_idx, bx, by]

    asub = subcell_offsets(a_logit, ax, ay) if cfg.subcell else None
    bsub = subcell_offsets(b_logit, bx, by) if cfg.subcell else None
    out = _atom_outputs(a_raw, ax, ay, a_valid, atom_type, atom_charge,
                        atom_hs, asub)
    out.update(_decode_bonds(w, neigh_max, bt_at_peak, rho60, bx, by,
                             b_valid, cfg, bsub))
    return out


# ---------------------------------------------------------------------------
# Sparse head evaluation: OutConv applied at gathered peak cells only.
# ---------------------------------------------------------------------------

def gather_windows(feats: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """Gather (2r+1)x(2r+1) feature windows centred at integer cells.

    feats: NHWC (B, G, G, C); xs, ys: (B, K). Returns (B, K, w, w, C) with
    zeros outside the map, the SAME zero padding of the dense 3x3 head
    convs, so per-cell evaluation is exact at borders too."""
    w = 2 * radius + 1
    di = torch.arange(-radius, radius + 1, device=xs.device)
    gx = (xs[:, :, None, None] + di[:, None]).expand(*xs.shape, w, w)
    gy = (ys[:, :, None, None] + di[None, :]).expand(*xs.shape, w, w)
    gh, gw = feats.shape[1], feats.shape[2]
    inb = (gx >= 0) & (gx < gh) & (gy >= 0) & (gy < gw)
    b_idx = torch.arange(feats.shape[0], device=xs.device)[:, None, None,
                                                          None]
    win = feats[b_idx, gx.clamp(0, gh - 1), gy.clamp(0, gw - 1)]
    return win * inb[..., None].to(win.dtype)


DENSE_HEADS_SPARSE_MODE = ("atom_target", "bond_target")

_ATOM_HEAD_NAMES = ("atom_type", "atom_charge", "atom_hs")
_ATOM_HEAD_WIDTHS = (14, 3, 2)
_BOND_HEAD_NAMES = ("bond_omega", "bond_type", "bond_rho")
_BOND_HEAD_WIDTHS = (60, 360, 60)


def fuse_head_params(model, names: Sequence[str], widths: Sequence[int],
                     dtype: torch.dtype = torch.float32) -> Dict:
    """Concatenate several OutConv heads of `model` into ONE evaluation:
    stage-1 3x3 kernels stacked along the output-feature axis as one
    (9*C, D) matrix (rows ordered row offset, col offset, channel), BN
    vectors concatenated (f32), stage-2 1x1 kernels block-diagonal. The
    conv weights are cast to `dtype` once, here."""
    heads = [model.head(n) for n in names]

    def cat(get):
        return torch.cat([get(h).detach().float() for h in heads])

    k0 = torch.cat([h.conv0.weight.detach().permute(2, 3, 1, 0)
                    for h in heads], dim=-1)            # (3, 3, C, D)
    k1 = torch.block_diag(*[h.conv1.weight.detach()[:, :, 0, 0].t()
                            for h in heads])            # (D, W)
    return {
        "k0": k0.reshape(-1, k0.shape[-1]).to(dtype),
        "b0": cat(lambda h: h.conv0.bias).to(dtype),
        "scale": cat(lambda h: h.bn0.weight),
        "bias": cat(lambda h: h.bn0.bias),
        "mean": cat(lambda h: h.bn0.running_mean),
        "var": cat(lambda h: h.bn0.running_var),
        "k1": k1.to(dtype),
        "b1": cat(lambda h: h.conv1.bias).to(dtype),
        "widths": tuple(widths),
    }


def apply_heads_fused(fz: Dict, windows: torch.Tensor,
                      dtype: torch.dtype = torch.float32):
    """Evaluate a fused head bundle at gathered 3x3 windows (B, K, 3, 3, C).
    Conv in `dtype`, BN in f32, LeakyReLU 0.01, 1x1 conv in `dtype`.
    Returns one (B, K, width) f32 logit array per head, in bundle order.

    The window contraction is one (B*K, 9C) x (9C, D) matmul, as the
    einsum bkijc,ijcd->bkd of the JAX package."""
    b, k = windows.shape[:2]
    x = windows.to(dtype).reshape(b * k, -1) @ fz["k0"].to(dtype)
    x = (x + fz["b0"].to(dtype)).float()
    x = (x - fz["mean"]) * torch.rsqrt(fz["var"] + 1e-5)
    x = x * fz["scale"] + fz["bias"]
    x = F.leaky_relu(x, 0.01).to(dtype)
    out = (x @ fz["k1"].to(dtype) + fz["b1"].to(dtype)).float()
    return list(out.reshape(b, k, -1).split(fz["widths"], dim=-1))


def sparse_heads(model, dtype: torch.dtype) -> Dict[str, Dict]:
    """The fused bundles the sparse path evaluates: atom heads, bond
    heads, and the omega head alone (for the 3x3 halo)."""
    return {
        "atom": fuse_head_params(model, _ATOM_HEAD_NAMES, _ATOM_HEAD_WIDTHS,
                                 dtype),
        "bond": fuse_head_params(model, _BOND_HEAD_NAMES, _BOND_HEAD_WIDTHS,
                                 dtype),
        "omega": fuse_head_params(model, ("bond_omega",), (NO,), dtype),
    }


@torch.no_grad()
def extract_peaks_sparse(heatmaps: Dict[str, torch.Tensor],
                         feats: torch.Tensor, heads: Dict[str, Dict],
                         cfg: DecodeConfig = DecodeConfig(),
                         dtype: torch.dtype = torch.float32
                         ) -> Dict[str, torch.Tensor]:
    """Sparse-head path. `heatmaps` holds the two dense 1-channel heads
    (atom_target, bond_target); `feats` is the shared NHWC (B, G, G, 128)
    trunk output (UNet.forward with dense_heads=DENSE_HEADS_SPARSE_MODE,
    return_features=True); `heads` is sparse_heads(model, dtype).

    Same decode as `extract_peaks` up to float reassociation, except the
    halo filter: here out-of-map neighbours are masked to -inf where the
    dense path clips to the edge cell."""
    thr = cfg.logit_threshold
    a_logit = heatmaps["atom_target"][..., 0]
    b_logit = heatmaps["bond_target"][..., 0]
    (a_raw, ax, ay, a_valid), (_, bx, by, b_valid) = _topk_logit_peaks_pair(
        a_logit, cfg.max_atoms, b_logit, cfg.max_bonds, thr)
    at, ac, ah = apply_heads_fused(heads["atom"],
                                   gather_windows(feats, ax, ay, 1), dtype)
    b, kb = bx.shape

    if cfg.halo_margin > 0:
        # Omega at the peak AND its 8 neighbours: one 5x5 window gather,
        # the nine shifted 3x3 sub-windows folded into the K axis for a
        # single fused evaluation.
        bwin5 = gather_windows(feats, bx, by, 2)          # (B,Kb,5,5,C)
        gh, gw = feats.shape[1], feats.shape[2]
        subs, valids = [], []
        for dx_ in (-1, 0, 1):
            for dy_ in (-1, 0, 1):
                subs.append(bwin5[:, :, dx_ + 1:dx_ + 4, dy_ + 1:dy_ + 4])
                nx, ny = bx + dx_, by + dy_
                valids.append((nx >= 0) & (nx < gh) & (ny >= 0) & (ny < gw))
        win9 = torch.stack(subs, dim=2).reshape(b, kb * 9, 3, 3, -1)
        (w9,) = apply_heads_fused(heads["omega"], win9, dtype)
        w9 = w9.reshape(b, kb, 9, NO)
        w = w9[:, :, 4]                                   # centre cell
        w9 = torch.where(torch.stack(valids, dim=2)[..., None], w9, NEG_INF)
        neigh_max = _circular_max3(w9).amax(dim=2)
        _, btf, rho60 = apply_heads_fused(heads["bond"],
                                          bwin5[:, :, 1:4, 1:4], dtype)
    else:
        w, btf, rho60 = apply_heads_fused(
            heads["bond"], gather_windows(feats, bx, by, 1), dtype)
        neigh_max = None

    asub = subcell_offsets(a_logit, ax, ay) if cfg.subcell else None
    bsub = subcell_offsets(b_logit, bx, by) if cfg.subcell else None
    out = _atom_outputs(a_raw, ax, ay, a_valid, at.argmax(-1),
                        ac.argmax(-1), ah.argmax(-1), asub)
    out.update(_decode_bonds(w, neigh_max, btf.reshape(b, kb, NB, NO),
                             rho60, bx, by, b_valid, cfg, bsub))
    return out


# ---------------------------------------------------------------------
# Packed peak transport: every integer-typed array of the peak dict goes
# into one int32 buffer and every float array into one float32 buffer
# per batch, so fetching a batch's peaks is two device->host copies.


def peaks_spec(peaks: Dict[str, torch.Tensor]):
    """Static packing layout for a peak dict: two tuples (int-typed, float-typed) of (key, trailing_shape, dtype_name,
    flat_width), ordered by key."""
    ispec, fspec = [], []
    for k in sorted(peaks):
        v = peaks[k]
        tail = tuple(v.shape[1:])
        width = int(np.prod(tail, dtype=np.int64))
        dt = str(torch.empty((), dtype=v.dtype).numpy().dtype)
        if np.issubdtype(np.dtype(dt), np.floating):
            fspec.append((k, tail, dt, width))
        else:
            ispec.append((k, tail, dt, width))
    return tuple(ispec), tuple(fspec)


def pack_peaks(peaks: Dict[str, torch.Tensor]):
    """Device side: concatenate the peak dict into (int32 (B, Ni), float32
    (B, Nf)) per the peaks_spec layout. Unpack with unpack_peaks_host."""
    ispec, fspec = peaks_spec(peaks)
    first = peaks[next(iter(peaks))]
    b = first.shape[0]

    def cat(spec, dtype):
        if not spec:
            return torch.zeros((b, 0), dtype=dtype, device=first.device)
        return torch.cat([peaks[k].reshape(b, -1).to(dtype)
                          for k, _, _, _ in spec], dim=1)

    return cat(ispec, torch.int32), cat(fspec, torch.float32)


def unpack_peaks_host(ibuf, fbuf, spec) -> Dict[str, np.ndarray]:
    """Host-side inverse of pack_peaks. ibuf/fbuf are numpy arrays or CPU
    tensors."""
    ispec, fspec = spec
    out = {}
    for buf, part in ((np.asarray(ibuf), ispec), (np.asarray(fbuf), fspec)):
        o = 0
        for k, tail, dt, width in part:
            v = buf[:, o:o + width].reshape((buf.shape[0],) + tail)
            o += width
            out[k] = v if str(v.dtype) == dt else v.astype(dt)
    return out


@torch.no_grad()
def device_peaks(model, bits: torch.Tensor, heads: Dict = None,
                 quant: Dict = None,
                 cfg: DecodeConfig = DecodeConfig(),
                 quant_packed: Dict = None) -> Dict[str, torch.Tensor]:
    """The serving program on the device: packed bits (B, H, W//8) on
    `model`'s device -> peak dict. Unpack (kernel 1) to the model's
    compute dtype, the U-Net, NMS/top-K (kernel 2), then the six wide
    heads at the peak cells (`heads`, from sparse_heads(model, dtype)) or,
    with `heads` None, every head densely. `quant`, an int8 bundle on the
    device (infer.quant), takes the backbone's place (sparse only; with
    `heads` None it raises), its conv sites' kernel weights
    `quant_packed` (quant.pack_bundle, made once a bundle).
    make_infer_pipeline and the `bench` sub-command both run it."""
    if quant is not None and heads is None:
        raise ValueError("the int8 backbone serves the sparse heads only; "
                         "give `heads` with `quant`")
    dtype = model.dtype
    images = device_unpack_bits(bits, train=False, dtype=dtype)
    if heads is None:
        return extract_peaks(model(images), cfg)
    if quant is not None:
        from .quant import forward_quant
        heatmaps, feats = forward_quant(quant, images, packed=quant_packed)
    else:
        heatmaps, feats = model(images, dense_heads=DENSE_HEADS_SPARSE_MODE,
                                return_features=True)
    return extract_peaks_sparse(heatmaps, feats, heads, cfg, dtype)


def copy_to_host(*tensors: torch.Tensor):
    """Start copying `tensors` (on one device) into pinned host memory,
    behind an event on the device's current stream; `host_arrays` waits
    for the event and returns them as numpy arrays. Tensors on the CPU
    are already there."""
    if tensors[0].device.type != "cuda":
        return tensors, None
    hosts = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                  for t in tensors)
    for h, t in zip(hosts, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(tensors[0].device))
    return hosts, event


def host_arrays(handle) -> List[np.ndarray]:
    """The numpy arrays of a `copy_to_host` handle, once they are there."""
    hosts, event = handle
    if event is not None:
        event.synchronize()
    return [h.numpy() for h in hosts]


def make_infer_pipeline(model, device="cuda",
                        decode_cfg: DecodeConfig = None,
                        threshold: float = 0.6, sparse: bool = True,
                        mesh=None, quant: Dict = None):
    """Serving pipeline: uint8 batch (B, 512, 512) -> host peak dict.

    Images are binarized and bit-packed on the host; the device unpacks
    them (kernel 1), runs the U-Net in the model's compute dtype, picks
    the peaks (kernel 2) and evaluates the wide heads at the peak cells
    (sparse=True, the default) or densely (sparse=False), then packs the
    peak dict into two buffers. Returns run(image_u8) with the halves
    run.dispatch (host prep + device work, no wait) and run.fetch
    (waits for the copies to pinned host memory, builds the numpy dict;
    safe on a worker thread).

    mesh: a `parallel.Mesh`; without it the pipeline runs on `device`.
      * A single-process mesh over several devices (the multi-chip
        batched inference of abcnet_tpu/infer/decode.py:520-622): a
        replica of the model on each, the batch cut into contiguous row
        blocks (B must divide by the number of devices), each block's
        unpack, U-Net, NMS/top-K, sparse heads and pack enqueued on its
        own device; fetch joins the blocks in row order.
      * A rank's mesh in a process group (`parallel.init_distributed`,
        mesh.world > 1; the JAX package's make_infer_pipeline after
        jax.distributed.initialize): `model` is first replicated from
        rank 0 in place (`parallel.replicate_tree`, a collective: every
        rank builds its pipeline), so every rank serves rank 0's
        weights. dispatch then takes this rank's rows only, the
        process-local slice of a global batch (`parallel.local_rows`),
        runs them on the rank's one device, and fetch returns their host
        peak dict, for the rank's own assembly pool; gathering results
        across ranks is the caller's business. Packed transport stays
        on: JAX turns it off there only because its global array spans
        shards a process cannot address, and a rank's buffers here are
        its own.

    quant: an int8 bundle from infer.quant.prepare_quant: the backbone
    becomes the s8 x s8 -> s32 path (on a GPU the conv_s8 kernel, its
    weights packed here once a device); peak extraction and the sparse
    wide heads are unchanged. Sparse mode only."""
    import copy

    from .quant import pack_bundle
    from .quant import to_device as quant_to_device

    if quant is not None and not sparse:
        raise ValueError("the int8 backbone serves the sparse pipeline only "
                         "(sparse=True)")
    devices = tuple(mesh.devices) if mesh is not None \
        else (resolve_device(device),)
    if mesh is not None and mesh.world > 1:
        replicate_tree(model.to(devices[0]), mesh)
    cfg = decode_cfg or DecodeConfig()
    dtype = model.dtype
    replicas = []
    for i, dev in enumerate(devices):
        rep = (model if i == 0 else copy.deepcopy(model)).to(dev).eval()
        qbundle = quant_to_device(quant, dev) if quant is not None else None
        replicas.append((rep, sparse_heads(rep, dtype) if sparse else None,
                         qbundle, pack_bundle(qbundle)
                         if qbundle is not None and dev.type == "cuda"
                         else None))
    spec_cache = {}

    def dispatch(image_u8):
        """Async half: pack on the host, copy each row block to its
        device, enqueue the device work and the copies of the peak
        buffers into pinned host memory. Returns a handle for `fetch`.
        Spans (utils/profiling.py): `dispatch`, parent of `pack` (host
        pack and pin) and `enqueue` (everything sent to the devices)."""
        with profiling.span("dispatch"):
            with profiling.span("pack"):
                bits = torch.from_numpy(pack_images(np.asarray(image_u8),
                                                    threshold))
                if bits.shape[0] % len(devices):
                    raise ValueError(f"batch {bits.shape[0]} does not "
                                     f"divide over {len(devices)} devices")
                if devices[0].type == "cuda":
                    bits = bits.pin_memory()
            with profiling.span("enqueue"):
                parts = []
                for (rep, heads, qbundle, qpacked), dev, block in zip(
                        replicas, devices, bits.chunk(len(devices))):
                    with torch.cuda.device(dev) if dev.type == "cuda" \
                            else contextlib.nullcontext():
                        peaks = device_peaks(
                            rep, block.to(dev, non_blocking=True), heads,
                            qbundle, cfg, qpacked)
                        if "spec" not in spec_cache:
                            spec_cache["spec"] = peaks_spec(peaks)
                        parts.append(copy_to_host(*pack_peaks(peaks)))
        return parts

    def fetch(parts):
        """Blocking half: wait for the copies, return the host peak dict
        with the blocks' rows in order. The waits release the interpreter
        lock, so a worker thread's fetch (and assembly) overlaps the main
        thread's dispatch. Spans: `fetch`, parent of `d2h_wait` (the
        copies) and `unpack` (the dict); once the copies are in, the
        batch's device spans (the model's, e.g. `cbam`) are read into
        their counters."""
        with profiling.span("fetch"):
            with profiling.span("d2h_wait"):
                arrays = [host_arrays(part) for part in parts]
            profiling.resolve_device_spans()
            with profiling.span("unpack"):
                hi = np.concatenate([i for i, _ in arrays])
                hf = np.concatenate([f for _, f in arrays])
                return unpack_peaks_host(hi, hf, spec_cache["spec"])

    def run(image_u8):
        return fetch(dispatch(image_u8))

    run.dispatch = dispatch
    run.fetch = fetch
    run.devices = devices
    return run
