"""Operation and byte counts of a configuration, from its shapes alone.

Every count here comes from the configuration file's sizes (image size,
the blocks' channel widths, the heads, the decode's top-K), never from
the program's objects or a FLOP counter, so a program change that moves
a convolution into a kernel of its own leaves the count where it was.

Peaks are those of NVIDIA's H100 SXM data sheet at its 700 W limit
(dense, no sparsity); the harness prints the card's own power limit
beside every number.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1.979e15


def conv_layers(cfg: Dict, dense_heads=None) -> Iterator[Tuple]:
    """(site, kind, H of the output, C_in, C_out, kernel) of every conv
    of the U-Net, in forward order. kind: "conv" (3x3 SAME), "convt" (3x3
    stride-2 transposed; H is its input's), "head3", "head1". The 3x3
    sites carry the names of the int8 backbone's scale sites.
    dense_heads: the heads evaluated on the whole map (default: all)."""
    h = cfg["image_size"]
    k = cfg["kernel_size"]
    for name, ci, co in cfg["stem"]:
        if name.startswith("down"):
            h //= 2
        yield f"{name}.0", "conv", h, ci, co, k
        yield f"{name}.1", "conv", h, co, co, k
    for name, ci, co in cfg["encoder"]:
        h //= 2
        yield f"{name}.0", "conv", h, ci, co, k
        yield f"{name}.1", "conv", h, co, co, k
    for name, ci, up_out, skip, co in cfg["decoder"]:
        yield f"{name}.t", "convt", h, ci, up_out, k
        h *= 2
        yield f"{name}.0", "conv", h, skip + up_out, co, k
        yield f"{name}.1", "conv", h, co, co, k
    for name, ci, co in cfg["tail"]:
        yield f"{name}.0", "conv", h, ci, co, k
        yield f"{name}.1", "conv", h, co, co, k
    f = cfg["head_features"]
    for head, width in cfg["heads"].items():
        if dense_heads is not None and head not in dense_heads:
            continue
        yield f"y:{head}", "head3", h, f, f, k
        yield f"out:{head}", "head1", h, f, width, 1


def conv_ops(kind: str, h: int, ci: int, co: int, k: int) -> int:
    """Multiply-adds times two of one image's conv (a transposed conv
    counts its input pixels' products, none of the zeros it inserts)."""
    return 2 * h * h * ci * co * k * k


def sparse_head_ops(cfg: Dict) -> int:
    """One image's wide heads at the peak cells: the atom heads at
    `max_atoms` cells; at `max_bonds` cells the bond heads, plus the omega
    head at the 8 neighbours of each (the halo filter). A head is a 3x3
    window product (9 f x f) and its 1x1 (f x width)."""
    d = cfg["decode"]
    f = cfg["head_features"]

    def head(width):
        return 2 * (9 * f * f + f * width)

    heads = cfg["heads"]
    atom = sum(head(heads[n]) for n in ("atom_type", "atom_charge",
                                        "atom_hs"))
    bond = sum(head(heads[n]) for n in ("bond_type", "bond_rho",
                                        "bond_omega"))
    return d["max_atoms"] * atom + d["max_bonds"] * (
        bond + 8 * head(heads["bond_omega"]))


def serve_least_seconds(cfg: Dict) -> float:
    """Least device time of one image of sparse serving: each conv and
    matrix product over the peak of the precision it runs in (int8 for
    the int8 backbone's 3x3 and transposed convs; bf16 for the rest)."""
    int8 = cfg.get("backbone") == "int8"
    t = sparse_head_ops(cfg) / BF16_OPS_PER_S
    for site, kind, h, ci, co, k in conv_layers(cfg, cfg["heatmap_heads"]):
        ops = conv_ops(kind, h, ci, co, k)
        if int8 and kind in ("conv", "convt", "head3"):
            t += ops / INT8_OPS_PER_S
        else:
            t += ops / BF16_OPS_PER_S
    return t


def bn_act_eval_bound_s(cfg: Dict, batch: int) -> float:
    """Least time of a batch's eval-mode BatchNorm sites of sparse serving
    (one after each 3x3 conv): read the bf16 conv output once, write the
    bf16 result once,
    over the HBM bandwidth (the statistics and the bias are a rounding
    error of it)."""
    nbytes = sum(2 * 2 * batch * h * h * co for _, kind, h, _, co, _ in
                 conv_layers(cfg, cfg["heatmap_heads"])
                 if kind in ("conv", "head3"))
    return nbytes / HBM_BYTES_PER_S


def conv_s8_bound_s(cfg: Dict, batch: int) -> float:
    """Least time of a batch's int8 3x3 sites (the trunk's and the
    heatmap heads'): per site the larger of its bytes (read the bf16
    input, write the bf16 output, f32 at the heads) over the HBM
    bandwidth and its int8 operations over the int8 peak."""
    t = 0.0
    for site, kind, h, ci, co, k in conv_layers(cfg, cfg["heatmap_heads"]):
        if kind not in ("conv", "head3"):
            continue
        px = batch * h * h
        out_bytes = 4 if kind == "head3" else 2
        t_bytes = (px * ci * 2 + px * co * out_bytes) / HBM_BYTES_PER_S
        t_ops = 2 * px * co * k * k * ci / INT8_OPS_PER_S
        t += max(t_bytes, t_ops)
    return t
