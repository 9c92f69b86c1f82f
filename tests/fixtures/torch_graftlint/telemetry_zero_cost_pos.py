"""telemetry-zero-cost, torch profile: telemetry inside a capture runs
at capture time only."""
import torch

from deeplearning4j_tpu_torch import monitor


def step(batch):
    monitor.counter("fixture_steps_total").inc()  # EXPECT
    with monitor.span("fixture/step"):  # EXPECT
        return batch * 2


class Runner:
    def run(self, graph, g, x):
        graph.capture(step, [])
        with torch.cuda.graph(g):
            monitor.add_span("fixture/captured", 0.0, 1.0)  # EXPECT
            y = x + 1
        return y
