"""cbam_gate_ms: milliseconds a batch of device time in the CBAM U-Net's
13 gate sites (channel gate, spatial gate, residual add, ReLU): the
program's counter `cbam_device_us` (CUDA events around each site,
models/unet_cbam.py, read on the loop's worker once the batch's fetch
is in), the mean over the profiled window's batches that have it;
nothing to read in a program or a model without the counter."""

from benchmark import program_spans


def per_batch_us(obs):
    """[(cbam_device_us, cbam_gates)] of each batch with the counter."""
    got = program_spans.recorded()
    if got is None:
        return []
    return [(c["cbam_device_us"], c.get("cbam_gates", 0))
            for c in got[1].values() if "cbam_device_us" in c]


def read(obs):
    rows = per_batch_us(obs)
    if not rows:
        return None
    return sum(us for us, _ in rows) / len(rows) / 1e3
