"""cbam_gate_roofline_pct: the CBAM U-Net's 13 gate sites against their
roofline. The least time of a batch's sites (each gated tensor read
twice, the residual read once, the output written once, bf16, over
3.35 TB/s; benchmark/counts_cbam.py) over their device time a batch
(`cbam_gate_ms`'s counter), in percent. Nothing to read where a batch
ran other than the configuration's 13 sites (counter `cbam_gates`), so
a run that skips a site cannot read high."""

from benchmark import counts_cbam, harness

gate = harness.metric_reader("cbam_gate_ms")


def read(obs):
    rows = gate.per_batch_us(obs)
    n = counts_cbam.sites(obs.cfg)
    if not rows or any(g != n for _, g in rows):
        return None
    per_batch_s = sum(us for us, _ in rows) / len(rows) / 1e6
    if not per_batch_s:
        return None
    return 100.0 * counts_cbam.gate_bound_s(
        obs.cfg, obs.traffic["batch"]) / per_batch_s
