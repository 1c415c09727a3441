"""dcn_roofline_pct: the DLA-34 + DCN model's 16 deformable sites against
their roofline. The least time of a batch's sites (per site the larger of
its operations, the offset / mask conv and the contraction, over the
H100's 989 TFLOP/s bf16 and its bytes, the input read once and the output
written once in bf16, over 3.35 TB/s; benchmark/counts_dla.py) over
their device time a batch (`dcn_ms`'s counter), in percent. Nothing to
read where a batch ran other than the configuration's sites (counter
`dcn_sites`), so a run that skips a site cannot read high."""

from benchmark import counts_dla, harness

dcn = harness.metric_reader("dcn_ms")


def read(obs):
    rows = dcn.per_batch_us(obs)
    n = len(counts_dla.sites(obs.cfg))
    if not rows or any(s != n for _, s in rows):
        return None
    per_batch_s = sum(us for us, _ in rows) / len(rows) / 1e6
    if not per_batch_s:
        return None
    return 100.0 * counts_dla.dcn_bound_s(
        obs.cfg, obs.traffic["batch"]) / per_batch_s
