"""assemble_us_per_peak: host assembly's microseconds a peak: the summed
length of the program's own `assemble` spans (infer/assemble.py:
assemble_batch) over the profiled window, over the valid atom and bond
peaks handed to it (its counters `atoms` and `bonds`). Taken where the
work happens, it holds still where the mix of molecules moves; nothing
to read in a program without the span or with no peak."""

from benchmark import program_spans


def read(obs):
    got = program_spans.recorded()
    if got is None:
        return None
    spans, counters = got
    peaks = sum(c.get("atoms", 0) + c.get("bonds", 0)
                for c in counters.values())
    ns = sum(s.end_ns - s.start_ns for s in spans if s.name == "assemble")
    if not peaks or not ns:
        return None
    return ns / 1e3 / peaks
