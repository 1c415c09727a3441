"""serve_mfu_pct.dla: the DLA-34 + DCN model's whole serving step's share
of the card's peak. One image's least compute time (each conv and matrix
product of the configuration from its shapes: the base, the deformable
sites' offset convs and contractions, the depthwise ups, the heatmap
heads on the map and the sparse heads at the decode's top-K cells, over
the H100's 989 TFLOP/s bf16; benchmark/counts_dla.py) over the time an
image took at the traced window's rate, in percent."""

from benchmark import counts_dla


def read(obs):
    if not obs.images or not obs.window_s:
        return None
    return 100.0 * counts_dla.serve_least_seconds(obs.cfg) / (
        obs.window_s / obs.images)
