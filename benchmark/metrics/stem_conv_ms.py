"""stem_conv_ms: milliseconds a batch of device time in the CBAM U-Net's
four 5x5 stem sites (inc1 and inc2: each conv with its bias, eval
BatchNorm and activation): the program's counter `stem_device_us` (CUDA
events around each site, models/unet_cbam.py, read on the loop's worker
once the batch's fetch is in), the mean over the profiled window's
batches that have it; nothing to read in a program or a model without
the counter."""

from benchmark import program_spans


def per_batch_us(obs):
    """[(stem_device_us, stem_sites)] of each batch with the counter."""
    got = program_spans.recorded()
    if got is None:
        return []
    return [(c["stem_device_us"], c.get("stem_sites", 0))
            for c in got[1].values() if "stem_device_us" in c]


def read(obs):
    rows = per_batch_us(obs)
    if not rows:
        return None
    return sum(us for us, _ in rows) / len(rows) / 1e3
