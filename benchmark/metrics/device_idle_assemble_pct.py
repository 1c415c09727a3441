"""device_idle_assemble_pct: the share of the profiled window's
device-idle time in which the loop's thread was inside the program's
`assemble` span (infer/assemble.py:assemble_batch), in percent: the
program's spans joined onto the device trace through the harness's
`dispatch` spans (benchmark/program_spans.py); nothing to read where
the program has no spans or the join does not hold."""

from benchmark import program_spans


def read(obs):
    return program_spans.device_idle_share(obs.trace, ("assemble",))
