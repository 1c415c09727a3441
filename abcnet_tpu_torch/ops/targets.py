"""On-device CenterNet target construction from compact labels.

Counterpart of abcnet_tpu/ops/targets.py. The host ships a few hundred
ints per sample (data/encode.py:compact_labels) and the dense maps are
scatter-built on the device. Semantics match the reference encoding
(3x3 halos 0.8/0.5, center 1.0, circular 60-bin omega rows with wrap,
spatial edges dropped), with the JAX package's one deliberate
divergence: overlapping writes combine with max() instead of sequential
last-write-wins, order-independent as a scatter must be.

Where the JAX package vmaps a per-sample scatter with mode="drop", this
module scatters the whole batch at once into a flat canvas with
`scatter_reduce_("amax")`. Entries to be dropped (a halo cell outside
the grid, a padding row, an atom without an hs label) are sent to one
extra slot past the end of the canvas, which is cut off afterwards:
nothing wraps, nothing is clamped onto a real cell, and no index is
brought to the host.

The full (6, 60, G, G) bond_type tensor is built only on request
(evaluation and tests): the training loss gathers predictions at the
labelled cells instead (ops/losses.py:_fused_bond_type_parts).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..data import vocab

G = vocab.GRID
NO = vocab.NUM_OMEGA_BINS

# 3x3 (spatial) and 3x3x3 (omega x spatial) halo offset tables.
_OFF2 = np.array([(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                 np.int64)                      # (9, 2)
_OFF3 = np.array([(do, dx, dy) for do in (-1, 0, 1)
                  for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                 np.int64)                      # (27, 3)
_CENTER2 = np.all(_OFF2 == 0, axis=1)           # (9,)
_CENTER3 = np.all(_OFF3 == 0, axis=1)           # (27,)


def _scatter_max(shape: Sequence[int], coords: Sequence[torch.Tensor],
                 keep: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Zeros of `shape` with vals scatter-maxed at `coords` (one integer
    tensor per axis of `shape`). An entry is dropped when `keep` is
    false or a coordinate lies outside its axis."""
    flat = torch.zeros_like(coords[0])
    n = 1
    for c, size in zip(coords, shape):
        keep = keep & (c >= 0) & (c < size)
        flat = flat * size + c
        n *= size
    flat = torch.where(keep, flat, n)            # the extra slot
    canvas = torch.zeros(n + 1, dtype=torch.float32, device=vals.device)
    canvas.scatter_reduce_(0, flat.reshape(-1),
                           vals.expand(flat.shape).reshape(-1), "amax",
                           include_self=True)
    return canvas[:n].view(*shape)


def _halo_vals(center: np.ndarray, halo: float, device) -> torch.Tensor:
    return torch.from_numpy(np.where(center, 1.0, halo).astype(np.float32)
                            ).to(device)


def build_atom_maps(atoms: torch.Tensor, n_atoms: torch.Tensor,
                    grid: int = G) -> Dict[str, torch.Tensor]:
    """atoms: int (B, A, 5) = (x, y, type, charge, hs); rows at or past
    n_atoms (B,) are padding. Returns dense maps (B, C, grid, grid)."""
    dev = atoms.device
    atoms = atoms.long()
    b, a = atoms.shape[:2]
    valid = (torch.arange(a, device=dev)[None, :] < n_atoms.long()[:, None])
    off = torch.from_numpy(_OFF2).to(dev)
    hx = atoms[:, :, 0, None] + off[:, 0]                   # (B, A, 9)
    hy = atoms[:, :, 1, None] + off[:, 1]
    img = torch.arange(b, device=dev)[:, None, None].expand_as(hx)
    keep = valid[:, :, None].expand_as(hx)
    heat = _halo_vals(_CENTER2, 0.8, dev)
    cls = _halo_vals(_CENTER2, 0.5, dev)

    def class_map(channel, n_classes, keep=keep):
        ch = channel[:, :, None].expand_as(hx)
        return _scatter_max((b, n_classes, grid, grid), (img, ch, hx, hy),
                            keep, cls)

    hs = atoms[:, :, 4]
    return {
        "atom_target": _scatter_max((b, 1, grid, grid),
                                    (img, torch.zeros_like(hx), hx, hy),
                                    keep, heat),
        "atom_type": class_map(atoms[:, :, 2], vocab.NUM_ATOM_CLASSES),
        "atom_charge": class_map(atoms[:, :, 3], vocab.NUM_CHARGE_CLASSES),
        # hs == -1: the atom carries no hydrogen-count label.
        "atom_hs": class_map(hs, vocab.NUM_HS_CLASSES,
                             keep & (hs >= 0)[:, :, None]),
    }


def build_bond_maps(bonds_i: torch.Tensor, bonds_f: torch.Tensor,
                    n_bonds: torch.Tensor, with_full_type: bool = False,
                    grid: int = G) -> Dict[str, torch.Tensor]:
    """bonds_i: int (B, Bn, 4) = (x, y, type_idx, omega_idx), plain bonds
    already direction-duplicated; bonds_f: (B, Bn, 1) = rho."""
    dev = bonds_i.device
    bonds_i = bonds_i.long()
    b, bn = bonds_i.shape[:2]
    valid = (torch.arange(bn, device=dev)[None, :] < n_bonds.long()[:, None])
    x, y = bonds_i[:, :, 0, None], bonds_i[:, :, 1, None]

    off2 = torch.from_numpy(_OFF2).to(dev)
    hx2, hy2 = x + off2[:, 0], y + off2[:, 1]               # (B, Bn, 9)
    img2 = torch.arange(b, device=dev)[:, None, None].expand_as(hx2)
    bond_target = _scatter_max(
        (b, 1, grid, grid), (img2, torch.zeros_like(hx2), hx2, hy2),
        valid[:, :, None].expand_as(hx2), _halo_vals(_CENTER2, 0.8, dev))

    off3 = torch.from_numpy(_OFF3).to(dev)
    # Omega is circular (bins wrap mod 60); space is not (cells drop).
    ho = torch.remainder(bonds_i[:, :, 3, None] + off3[:, 0], NO)
    hx3, hy3 = x + off3[:, 1], y + off3[:, 2]               # (B, Bn, 27)
    img3 = torch.arange(b, device=dev)[:, None, None].expand_as(hx3)
    keep3 = valid[:, :, None].expand_as(hx3)
    shape3 = (b, NO, grid, grid)
    coords3 = (img3, ho, hx3, hy3)
    type_vals = _halo_vals(_CENTER3, 0.5, dev)

    out = {
        "bond_target": bond_target,
        "bond_omega": _scatter_max(shape3, coords3, keep3,
                                   _halo_vals(_CENTER3, 0.8, dev)),
        "bond_rho": _scatter_max(shape3, coords3, keep3,
                                 bonds_f[:, :, 0, None].float()),
        "bond_type_mass": _scatter_max(shape3, coords3, keep3, type_vals),
    }
    if with_full_type:
        ch = bonds_i[:, :, 2, None].expand_as(hx3)
        out["bond_type"] = _scatter_max(
            (b, vocab.NUM_BOND_CLASSES, NO, grid, grid),
            (img3, ch, ho, hx3, hy3), keep3, type_vals)
    return out


def build_targets(batch: Dict[str, torch.Tensor],
                  with_full_type: bool = False,
                  grid: int = G) -> Dict[str, torch.Tensor]:
    """Batched target construction. `batch` holds the compact label
    tensors with a leading batch dim (atoms, n_atoms, bonds_i, bonds_f,
    n_bonds). Maps are channel-first, as the reference's."""
    return {**build_atom_maps(batch["atoms"], batch["n_atoms"], grid),
            **build_bond_maps(batch["bonds_i"], batch["bonds_f"],
                              batch["n_bonds"], with_full_type, grid)}
