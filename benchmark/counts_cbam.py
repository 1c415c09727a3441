"""Operation and byte counts of a CBAM U-Net configuration
(`unet_cbam_bf16`), from its file's shapes alone, as benchmark/counts.py
counts the production U-Net's: never from the program's objects or a
FLOP counter.

Operations (multiply-adds times two, one image): each block's two k x k
convs (5x5 in the stem's first two blocks), its residual 1x1 where the
width changes, the spatial gate's 7x7 conv (2 -> 1), the channel gate's
shared MLP (C -> C/16 -> C, once for the mean and once for the max), the
transposed convs, the two heatmap heads on the whole map and the six
wide heads at the decode's top-K cells (counts.sparse_head_ops).

Bytes of the gates: at each of the 13 CBAM sites the least a fused gate
moves in bf16: the gated tensor read twice (for the channel gate's
reductions, then for the spatial gate's and the product), the residual
read once and the output written once.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

from .counts import BF16_OPS_PER_S, HBM_BYTES_PER_S, sparse_head_ops

BF16_BYTES = 2


def blocks(cfg: Dict) -> Iterator[Tuple[str, int, int, int, int]]:
    """(block, H, C_in, C_out, kernel) of every CBAM block, forward order;
    H is the side of its output."""
    h = cfg["image_size"]
    for name, ci, co, k in cfg["stem"]:
        if name.startswith("down"):
            h //= 2
        yield name, h, ci, co, k
    for name, ci, co, k in cfg["encoder"]:
        h //= 2
        yield name, h, ci, co, k
    for name, ci, up_out, skip, co in cfg["decoder"]:
        h *= 2
        yield name, h, skip + up_out, co, 3
    for name, ci, co, k in cfg["tail"]:
        yield name, h, ci, co, k


def conv_layers(cfg: Dict, dense_heads=None) -> Iterator[Tuple]:
    """(site, H of the output, C_in, C_out, kernel) of every conv and
    matrix product, in forward order: "<block>.0", ".1" (the block's
    convs), ".res" (its 1x1 residual), ".spatial" (the gate's 7x7),
    ".mlp0", ".mlp1" (the channel MLP's two layers as 1x1 products on
    the two pooled vectors: H = 1, counted twice), "<up>.t" (the
    transposed conv, H its input's), "y:<head>", "out:<head>" (the
    heads given in `dense_heads`, all by default)."""
    c = cfg["cbam"]
    h_out = {name: h for name, h, _, _, _ in blocks(cfg)}
    ups = {row[0]: row for row in cfg["decoder"]}
    for name, h, ci, co, k in blocks(cfg):
        if name in ups:
            _, uci, up_out, _, _ = ups[name]
            yield f"{name}.t", h // 2, uci, up_out, cfg["decoder_kernel"]
        yield f"{name}.0", h, ci, co, k
        yield f"{name}.1", h, co, co, k
        if ci != co:
            yield f"{name}.res", h, ci, co, 1
        mid = max(co // c["reduction"], 1)
        for _ in range(2):
            yield f"{name}.mlp0", 1, co, mid, 1
            yield f"{name}.mlp1", 1, mid, co, 1
        yield f"{name}.spatial", h, 2, 1, c["spatial_kernel"]
    h = h_out[cfg["tail"][-1][0]]
    f = cfg["head_features"]
    for head, width in cfg["heads"].items():
        if dense_heads is not None and head not in dense_heads:
            continue
        yield f"y:{head}", h, f, f, 3
        yield f"out:{head}", h, f, width, 1


def ops(h: int, ci: int, co: int, k: int) -> int:
    """Multiply-adds times two of one image's conv (a transposed conv's
    input pixels' products)."""
    return 2 * h * h * ci * co * k * k


def dense_ops(cfg: Dict, dense_heads=None) -> int:
    """One image's forward with `dense_heads` on the whole map."""
    return sum(ops(*layer[1:]) for layer in conv_layers(cfg, dense_heads))


def serve_least_seconds(cfg: Dict) -> float:
    """Least device time of one image of sparse serving: every operation
    above over the bf16 peak."""
    return (dense_ops(cfg, cfg["heatmap_heads"]) + sparse_head_ops(cfg)) \
        / BF16_OPS_PER_S


def gate_bytes(cfg: Dict, batch: int) -> int:
    """The least bytes the 13 gate sites of a batch move in bf16."""
    return sum(4 * BF16_BYTES * batch * h * h * co
               for _, h, _, co, _ in blocks(cfg))


def gate_bound_s(cfg: Dict, batch: int) -> float:
    """Least time of a batch's gate sites: their bytes over the HBM
    bandwidth."""
    return gate_bytes(cfg, batch) / HBM_BYTES_PER_S


def sites(cfg: Dict) -> int:
    return sum(1 for _ in blocks(cfg))
