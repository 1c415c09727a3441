"""device_idle_enqueue_pct: the share of the profiled window's
device-idle time in which the loop's thread was inside the program's
`enqueue` span (the device program's launches: the device waits for
them), in percent, joined as device_idle_assemble_pct is."""

from benchmark import program_spans


def read(obs):
    return program_spans.device_idle_share(obs.trace, ("enqueue",))
