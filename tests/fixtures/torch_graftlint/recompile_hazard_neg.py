"""recompile-hazard near-misses, torch profile: static branches (shape,
dim, dtype, None-ness, isinstance) inside a capture, value branches
outside one."""
import torch


def capture_body(g, x, mask=None):
    with torch.cuda.graph(g):
        if x.shape[0] > 1:
            x = x[1:]
        if mask is not None:
            x = x * mask
        if x.dim() == 2:
            x = x.sum(0)
    return x


def step(batch):
    if isinstance(batch, tuple):
        batch = batch[0]
    if batch.dtype == torch.float16:
        batch = batch.float()
    return batch


def eager(x):
    if x.sum() > 0:
        return x
    return -x


class Runner:
    def run(self, graph):
        graph.capture(step, [])
