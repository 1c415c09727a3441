"""serve_device_ms: device milliseconds a batch of the serving program,
the length of the union of the traced window's device operations over
the batches traced."""


def read(obs):
    busy = obs.trace.busy_us
    if not busy or not obs.units:
        return None
    return busy / 1e3 / obs.units
