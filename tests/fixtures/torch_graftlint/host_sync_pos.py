"""host-sync-in-hot-path, torch profile: host syncs inside CUDA graph
captures (a capture's `with` body, a function passed to capture() or
warm_up(), the fn handed to _run_step)."""
import numpy as np
import torch


def capture_body(g, static_x, w):
    with torch.cuda.graph(g):
        y = static_x @ w
        loss = y.sum()
        print(loss.item())  # EXPECT
        host = y.cpu()  # EXPECT
        arr = y.numpy()  # EXPECT
        vals = y.tolist()  # EXPECT
        scale = float(loss)  # EXPECT
        torch.cuda.synchronize()  # EXPECT
        np.asarray(y)  # EXPECT
    return host, arr, vals, scale


def step(batch):
    loss = (batch * 2).sum()
    flag = bool(loss)  # EXPECT
    return loss, flag


def micro(struct):
    return int(struct.sum())  # EXPECT


class Runner:
    def run(self, graph):
        graph.capture(step, [])
        graph.warm_up(lambda: torch.ones(3).sum().item())  # EXPECT
        return self._run_step(("micro",), (), micro)
