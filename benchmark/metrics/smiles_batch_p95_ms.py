"""smiles_batch_p95_ms: the conversion loop's batch latency, from a
batch's dispatch call to the return of its SMILES from assembly (batches
matched first in, first out), nearest-rank 95th percentile over every
batch of the timed window (a --trace 1 run keeps its timed window's
spans: at 51 s some 550-650 batches, so the tail rests on some 30). A
closed loop runs at capacity, where the tail swings with the host's
smallest stall; the rate is the end-to-end metric, and this reads how
long a batch waits."""

from benchmark import harness


def read(obs):
    lat = [a[1] - d[0] for d, a in zip(obs.spans.get("dispatch", ()),
                                        obs.spans.get("assemble", ()))]
    if not lat:
        return None
    return harness.percentile(lat, 95) * 1e3
