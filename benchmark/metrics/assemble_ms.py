"""assemble_ms: main-thread milliseconds a batch in the harness's `assemble` span
around the call into that layer, the mean over the timed window's
batches (a --trace 1 run keeps them from its timed window, which the
profiler does not slow)."""


def read(obs):
    spans = obs.spans.get("assemble") or []
    if not spans:
        return None
    return sum(e - s for s, e in spans) / len(spans) * 1e3
