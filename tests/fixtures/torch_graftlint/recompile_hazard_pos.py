"""recompile-hazard, torch profile: Python branches on a tensor's value
inside a capture (recorded once, replayed for every later value)."""
import torch


def capture_body(g, x):
    with torch.cuda.graph(g):
        y = x * 2
        if y.sum() > 0:  # EXPECT
            y = y + 1
        while x.max() > 1:  # EXPECT
            x = x / 2
    return y


def step(batch, scale):
    if scale > 1.0:  # EXPECT
        return batch * scale
    return batch


class Runner:
    def run(self, graph):
        graph.capture(step, [])
