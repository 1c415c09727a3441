"""Operation and byte counts of the DLA-34 + DCN configuration
(`dla34_dcn_bf16`), from its file's shapes alone, as benchmark/counts.py
counts the production U-Net's: never from the program's objects or a
FLOP counter.

Operations (multiply-adds times two, one image): the base's convs (the
7x7 stem, the conv levels, each tree's blocks, its 1x1 projection where
the width changes and is used, its root), at each of the 16 deformable
sites the offset / mask conv (3x3 to 27) and the contraction (9 C_in
C_out a pixel), each depthwise up (4 products a channel an output
pixel), the two heatmap heads on the whole map and the six wide heads at
the decode's top-K cells.

Bytes of a deformable site: the least the whole site moves in bf16, its
input read once and its output written once.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from .counts import BF16_OPS_PER_S, HBM_BYTES_PER_S

BF16_BYTES = 2
OFFSET_MASK = 27


def _tree(name: str, levels: int, ci: int, co: int, h: int,
          level_root: bool, root_dim: int = 0) -> Iterator[Tuple]:
    root_dim = root_dim or 2 * co
    if level_root:
        root_dim += ci
    if levels == 1:
        if ci != co:
            yield f"{name}.project", "conv", h, ci, co, 1
        yield f"{name}.tree1.0", "conv", h, ci, co, 3
        yield f"{name}.tree1.1", "conv", h, co, co, 3
        yield f"{name}.tree2.0", "conv", h, co, co, 3
        yield f"{name}.tree2.1", "conv", h, co, co, 3
        yield f"{name}.root", "conv", h, root_dim, co, 1
        return
    yield from _tree(f"{name}.tree1", levels - 1, ci, co, h, False)
    yield from _tree(f"{name}.tree2", levels - 1, co, co, h, False,
                     root_dim + co)


def base_layers(cfg: Dict) -> Iterator[Tuple]:
    """(site, kind, H of the output, C_in, C_out, kernel) of the base."""
    c, h = cfg["channels"], cfg["image_size"]
    yield "base_layer", "conv", h, cfg["in_channels"], c[0], \
        cfg["base_layer_kernel"]
    yield "level0", "conv", h, c[0], c[0], 3
    h //= 2
    yield "level1", "conv", h, c[0], c[1], 3
    for name, levels, ci, co, level_root in cfg["tree_levels"]:
        h //= 2
        yield from _tree(name, levels, ci, co, h, level_root)


def sites(cfg: Dict):
    """(site, H, C_in, C_out) of the 16 deformable sites, forward order,
    H their side at the configuration's image size."""
    scale = cfg["image_size"] / 512
    return [(name, int(h * scale), ci, co)
            for name, h, ci, co in cfg["dcn"]["sites"]]


def conv_layers(cfg: Dict, dense_heads=None) -> Iterator[Tuple]:
    """(site, kind, H of the output, C_in, C_out, kernel) of every conv
    and matrix product, in forward order. kind: "conv", "offset" (a
    site's offset / mask conv), "dcn" (a site's contraction), "up" (a
    depthwise up: C_in 1 and kernel 2, the four products an output pixel
    takes from its 2f x 2f kernel), "head3", "head1" (the heads given in
    `dense_heads`, all by default)."""
    yield from base_layers(cfg)
    k = cfg["dcn"]["kernel"]
    for name, h, ci, co in sites(cfg):
        if ".node" in name:
            yield name.replace("node", "up"), "up", h, 1, ci, 2
        yield f"{name}.offset", "offset", h, ci, OFFSET_MASK, k
        yield name, "dcn", h, ci, co, k
    h = cfg["image_size"] // cfg["head_stride"]
    f, mid = cfg["head_features"], cfg["head_conv"]
    for head, width in cfg["heads"].items():
        if dense_heads is not None and head not in dense_heads:
            continue
        yield f"y:{head}", "head3", h, f, mid, 3
        yield f"out:{head}", "head1", h, mid, width, 1


def ops(h: int, ci: int, co: int, k: int) -> int:
    """Multiply-adds times two of one image's conv."""
    return 2 * h * h * ci * co * k * k


def dense_ops(cfg: Dict, dense_heads=None, kinds=None) -> int:
    """One image's forward with `dense_heads` on the whole map (only the
    layers of `kinds`, where given)."""
    return sum(ops(*layer[2:]) for layer in conv_layers(cfg, dense_heads)
               if kinds is None or layer[1] in kinds)


def sparse_head_ops(cfg: Dict) -> int:
    """One image's wide heads at the peak cells: the atom heads at
    `max_atoms` cells; at `max_bonds` cells the bond heads, plus the omega
    head at the 8 neighbours of each (the halo filter). A head is a 3x3
    window product (9 f x head_conv) and its 1x1 (head_conv x width)."""
    d, heads = cfg["decode"], cfg["heads"]
    f, mid = cfg["head_features"], cfg["head_conv"]

    def head(width):
        return 2 * (9 * f * mid + mid * width)

    atom = sum(head(heads[n]) for n in ("atom_type", "atom_charge",
                                        "atom_hs"))
    bond = sum(head(heads[n]) for n in ("bond_type", "bond_rho",
                                        "bond_omega"))
    return d["max_atoms"] * atom + d["max_bonds"] * (
        bond + 8 * head(heads["bond_omega"]))


def serve_least_seconds(cfg: Dict) -> float:
    """Least device time of one image of sparse serving: every operation
    above over the bf16 peak."""
    return (dense_ops(cfg, cfg["heatmap_heads"]) + sparse_head_ops(cfg)) \
        / BF16_OPS_PER_S


def site_ops(h: int, ci: int, co: int, k: int = 3) -> int:
    """One image's operations at a deformable site: the offset / mask conv
    and the contraction."""
    return ops(h, ci, OFFSET_MASK, k) + ops(h, ci, co, k)


def site_bytes(batch: int, h: int, ci: int, co: int) -> int:
    """A site's least bytes over a batch: input read, output written,
    bf16."""
    return BF16_BYTES * batch * h * h * (ci + co)


def dcn_bound_s(cfg: Dict, batch: int) -> float:
    """Least time of a batch's deformable sites: per site the larger of
    its operations over the bf16 peak and its bytes over the HBM
    bandwidth, summed."""
    return sum(max(batch * site_ops(h, ci, co) / BF16_OPS_PER_S,
                   site_bytes(batch, h, ci, co) / HBM_BYTES_PER_S)
               for _, h, ci, co in sites(cfg))
