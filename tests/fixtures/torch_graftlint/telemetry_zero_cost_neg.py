"""telemetry-zero-cost near-misses, torch profile: telemetry around the
replay, with cheap attrs."""
import torch

from deeplearning4j_tpu_torch import monitor


def run(g, x):
    with torch.cuda.graph(g):
        y = x + 1
    with monitor.span("fixture/replay", rows=len(x), n=int(x.numel())):
        g.replay()
    monitor.counter("fixture_replays_total").inc()
    return y
