"""stem_conv_roofline_pct: the CBAM U-Net's four 5x5 stem sites against
their roofline. The least time of a batch's sites (each the larger of
its operations over the bf16 peak and its bytes over the HBM bandwidth,
the input read once and the output written once in bf16; the shapes of
benchmark/counts_cbam.py's conv layers, the same work whatever computes
it: 2.936 ms at batch 64) over their device time a batch
(`stem_conv_ms`'s counter), in percent. Nothing to read where a batch
ran other than the configuration's sites (counter `stem_sites`), so a
run that skips a site cannot read high."""

from benchmark import counts_cbam, harness
from benchmark.counts import BF16_OPS_PER_S, HBM_BYTES_PER_S

stem = harness.metric_reader("stem_conv_ms")
KERNEL = 5


def sites(cfg):
    """(H, C_in, C_out) of each 5x5 conv of the configuration."""
    return [(h, ci, co) for _, h, ci, co, k in counts_cbam.conv_layers(cfg)
            if k == KERNEL]


def bound_s(cfg, batch):
    """Least time of a batch's stem sites."""
    return sum(max(batch * counts_cbam.ops(h, ci, co, KERNEL)
                   / BF16_OPS_PER_S,
                   batch * h * h * (ci + co) * counts_cbam.BF16_BYTES
                   / HBM_BYTES_PER_S)
               for h, ci, co in sites(cfg))


def read(obs):
    rows = stem.per_batch_us(obs)
    n = len(sites(obs.cfg))
    if not n or not rows or any(s != n for _, s in rows):
        return None
    per_batch_s = sum(us for us, _ in rows) / len(rows) / 1e6
    if not per_batch_s:
        return None
    return 100.0 * bound_s(obs.cfg, obs.traffic["batch"]) / per_batch_s
