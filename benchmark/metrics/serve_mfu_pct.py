"""serve_mfu_pct: the whole serving step's share of the card's peak. One
image's least compute time (each conv and matrix product of the
configuration from its shapes, the sparse heads at the decode's top-K
cells, over the H100 peak of the precision it runs in: bf16 989
TFLOP/s, int8 1,979 TOP/s; benchmark/counts.py) over the time an image
took at the traced window's rate, in percent."""

from benchmark import counts


def read(obs):
    if not obs.images or not obs.window_s:
        return None
    return 100.0 * counts.serve_least_seconds(obs.cfg) / (
        obs.window_s / obs.images)
