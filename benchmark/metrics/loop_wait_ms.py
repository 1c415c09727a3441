"""loop_wait_ms: milliseconds a batch the conversion loop's thread waits
for the fetch thread's peak dict (the program's own `wait` span in
__main__.img2smiles_loop), the mean over the profiled window's batches;
nothing to read in a program without the span."""

from benchmark import program_spans


def read(obs):
    return program_spans.mean_ms("wait")
