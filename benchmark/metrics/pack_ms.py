"""pack_ms: milliseconds a batch in the program's own `pack` span
(infer/decode.py:make_infer_pipeline's dispatch: binarize and bit-pack
the drawings on the host, pin them), the mean over the profiled window's
batches. The loop records its spans only under the profiler, so only a
--trace 1 run has them; nothing to read in a program without them."""

from benchmark import program_spans


def read(obs):
    return program_spans.mean_ms("pack")
