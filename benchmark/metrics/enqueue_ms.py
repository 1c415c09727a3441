"""enqueue_ms: milliseconds a batch in the program's own `enqueue` span
(infer/decode.py:make_infer_pipeline's dispatch: the copy to the device,
the device program's launches, the peak buffers' copies back), the mean
over the profiled window's batches; nothing to read in a program
without the span."""

from benchmark import program_spans


def read(obs):
    return program_spans.mean_ms("enqueue")
