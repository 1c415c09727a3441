"""abcnet_tpu_torch.ops.targets against abcnet_tpu.ops.targets on the CPU.

The maps hold only the constants 0, 0.5, 0.8, 1 and copied rho values,
combined by max, so the tolerance is equality.

One divergence is pinned here. A halo cell at row or column -1 (a label
on row or column 0) must be dropped, as the reference's slice clamping
and the dense numpy oracle (encode_targets_np) drop it. The port does.
The JAX package's `.at[...].max(mode="drop")` applies numpy's negative
indexing before the bounds check, so it writes that cell to row or
column G - 1 instead. Everywhere else the two agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from abcnet_tpu.data.pipeline import synthetic_batch
from abcnet_tpu.ops import targets as jax_targets
from abcnet_tpu_torch.data import encode
from abcnet_tpu_torch.ops import targets
from torch_parity import label_batch

LABEL_KEYS = ("atoms", "n_atoms", "bonds_i", "bonds_f", "n_bonds")


def _both(batch, full, grid):
    want = jax_targets.build_targets(
        {k: jnp.asarray(batch[k]) for k in LABEL_KEYS},
        with_full_type=full, grid=grid)
    got = targets.build_targets(
        {k: torch.from_numpy(batch[k]) for k in LABEL_KEYS},
        with_full_type=full, grid=grid)
    assert sorted(want) == sorted(got)
    return {k: np.asarray(v) for k, v in want.items()}, \
        {k: v.numpy() for k, v in got.items()}


def _edge_batch(grid):
    """Labels on the far edge, overlapping halos, omega wrap at both
    ends, hs labels of every kind, padding rows holding junk, an empty
    image. Nothing on row or column 0 (see the module docstring)."""
    b = {k: v.copy() for k, v in synthetic_batch(3, 1, grid * 4).items()
         if k in LABEL_KEYS}
    g = grid - 1
    b["atoms"][0, 0, :2] = (g, g)
    b["atoms"][0, 1, :2] = (1, g)
    b["atoms"][0, 2, :2] = (g, 1)
    b["atoms"][0, 3, :2] = (10, 10)          # overlapping halos, other types
    b["atoms"][0, 4, :2] = (10, 11)
    b["atoms"][0, 5, :2] = (11, 11)
    b["atoms"][0, 3:6, 2] = (1, 2, 3)
    b["atoms"][1, :24, 4] = np.arange(24) % 3 - 1        # hs -1, 0, 1
    b["atoms"][1, :24, 3] = np.arange(24) % 3
    b["bonds_i"][0, 0] = (g, 1, 2, 59)       # omega wraps 59 -> 0
    b["bonds_i"][0, 1] = (1, g, 3, 0)        # omega wraps 0 -> 59
    b["bonds_i"][0, 2] = (20, 20, 1, 30)     # overlapping, other rho
    b["bonds_i"][0, 3] = (20, 21, 4, 31)
    b["bonds_f"][0, 2:4, 0] = (3.5, 7.25)
    b["n_atoms"][1] = 10
    b["atoms"][1, 10:, :] = 7                # junk in the padding rows
    b["n_bonds"][1] = 6
    b["bonds_i"][1, 6:, :] = 5
    b["n_atoms"][2] = 0
    b["n_bonds"][2] = 0
    return b


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("case,grid", [("synthetic", 32), ("synthetic", 128),
                                       ("edges", 32), ("edges", 128),
                                       ("fixture", 128)])
def test_build_targets_equal_jax(case, grid, full):
    if case == "synthetic":
        batch = synthetic_batch(2 if grid == 128 else 4, 0, grid * 4)
    elif case == "edges":
        batch = _edge_batch(grid)
    else:
        batch = label_batch(range(0, 64, 16))
    want, got = _both(batch, full, grid)
    assert ("bond_type" in got) == full
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["atom_target"].max() == 1.0


def test_row_zero_halo_is_dropped_not_wrapped():
    grid = 32
    batch = {k: v.copy() for k, v in synthetic_batch(1, 2, grid * 4).items()
             if k in LABEL_KEYS}
    batch["n_atoms"][:] = 2
    batch["atoms"][0, 0] = (0, 5, 1, 0, 1)
    batch["atoms"][0, 1] = (7, 0, 2, 1, 0)
    batch["n_bonds"][:] = 1
    batch["bonds_i"][0, 0] = (0, 0, 1, 3)
    want, got = _both(batch, True, grid)
    for k in want:
        # nothing lands on the far row or column
        assert got[k][..., grid - 1, :].sum() == 0, k
        assert got[k][..., :, grid - 1].sum() == 0, k
        # the JAX package wraps the -1 cells there; elsewhere they agree
        assert want[k][..., grid - 1, :].sum() > 0, k
        np.testing.assert_array_equal(got[k][..., :grid - 1, :grid - 1],
                                      want[k][..., :grid - 1, :grid - 1],
                                      err_msg=k)


def test_targets_match_the_dense_numpy_oracle_where_halos_do_not_overlap():
    """encode_targets_np writes sequentially (last write wins), the
    scatter takes the max; on labels whose halos do not overlap they
    agree, the edge cells included."""
    atoms = [encode.AtomLabel("N", 0, 0, 1, 1), encode.AtomLabel("C", 200, 300, 0, -1),
             encode.AtomLabel("O", 508, 508, -1, 0)]
    bonds = [encode.BondLabel(1, 100, 100, 10, 4, 0, 0),
             encode.BondLabel(2, 0, 400, 0, 12, 1, 1)]
    dense = encode.encode_targets_np(atoms, bonds)
    lab = encode.compact_labels(atoms, bonds)
    got = targets.build_targets(
        {k: torch.from_numpy(np.asarray(v))[None] for k, v in lab.items()},
        with_full_type=True)
    for k in ("atom_target", "atom_type", "atom_charge", "atom_hs",
              "bond_target", "bond_type", "bond_rho", "bond_omega"):
        np.testing.assert_allclose(got[k][0].numpy(), dense[k], rtol=0,
                                   atol=1e-6, err_msg=k)
