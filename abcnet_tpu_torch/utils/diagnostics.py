"""Perfect-prediction logits from targets, counterpart of
abcnet_tpu/utils/diagnostics.py.

Lifting ground-truth target maps to what a perfectly trained network
would output exercises the whole decode + assembly stack without a
model: the strongest correctness check available without training.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def perfect_logits_production(sample) -> Dict[str, torch.Tensor]:
    """Perfect logits through the production target builder
    (ops/targets.py, max-combine scatter): what the trained model is
    taught. `sample` has `atoms_string` and `bonds_string`."""
    from ..data.encode import (compact_labels, parse_atoms_string,
                               parse_bonds_string)
    from ..ops.targets import build_targets

    labels = compact_labels(parse_atoms_string(sample.atoms_string),
                            parse_bonds_string(sample.bonds_string),
                            1.0, 1.0, 0, 0)
    batch = {k: torch.from_numpy(np.asarray(v)[None])
             for k, v in labels.items()}
    t = build_targets(batch, with_full_type=True)
    t = {k: v[0].numpy() for k, v in t.items() if k != "bond_type_mass"}
    return fake_logits_from_targets(t)


def fake_logits_from_targets(t: Dict[str, np.ndarray]
                             ) -> Dict[str, torch.Tensor]:
    """Dense channel-first target maps -> NHWC 'perfect' logits (B = 1):
    sigmoid heads centre 5, halo 3, background -5; class heads 10 x the
    target."""
    g = t["atom_target"].shape[-1]

    def sig(x):
        return x * 10.0 - 5.0

    def nhwc(x):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(x, np.float32)[None].transpose(0, 2, 3, 1)))

    bt = (np.asarray(t["bond_type"], np.float32) * 10.0).transpose(
        2, 3, 0, 1)                                     # (G, G, 6, 60)
    return {
        "atom_target": nhwc(sig(t["atom_target"])),
        "atom_type": nhwc(t["atom_type"] * 10.0),
        "atom_charge": nhwc(t["atom_charge"] * 10.0),
        "atom_hs": nhwc(t["atom_hs"] * 10.0),
        "bond_target": nhwc(sig(t["bond_target"])),
        "bond_type": torch.from_numpy(np.ascontiguousarray(
            bt.reshape(g, g, -1)[None])),
        "bond_rho": nhwc(t["bond_rho"]),
        "bond_omega": nhwc(sig(t["bond_omega"])),
    }
