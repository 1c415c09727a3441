"""device_idle_pct.serve: the share of the traced serving window in which
no operation ran on the device, in percent."""


def read(obs):
    tr = obs.trace
    if not tr.window_us or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.window_us)
