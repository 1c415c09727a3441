"""dcn_ms: milliseconds a batch of device time in the DLA-34 + DCN
model's 16 deformable sites (each site's offset / mask conv, sampling,
contraction, BatchNorm and ReLU): the program's counter `dcn_device_us`
(CUDA events around each site, models/dla_dcn.py, read on the loop's
worker once the batch's fetch is in), the mean over the profiled window's
batches that have it; nothing to read in a program or a model without
the counter."""

from benchmark import program_spans


def per_batch_us(obs):
    """[(dcn_device_us, dcn_sites)] of each batch with the counter."""
    got = program_spans.recorded()
    if got is None:
        return []
    return [(c["dcn_device_us"], c.get("dcn_sites", 0))
            for c in got[1].values() if "dcn_device_us" in c]


def read(obs):
    rows = per_batch_us(obs)
    if not rows:
        return None
    return sum(us for us, _ in rows) / len(rows) / 1e3
