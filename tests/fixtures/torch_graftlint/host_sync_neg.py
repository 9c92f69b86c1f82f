"""host-sync-in-hot-path near-misses, torch profile: shape/dim/numel
reads inside a capture, syncs after the capture or in code no capture
runs."""
import torch


def capture_body(g, static_x):
    n = int(static_x.shape[0])
    k = int(static_x.numel())
    with torch.cuda.graph(g):
        y = static_x.reshape(n, -1) * float(2.0)
        z = y[: static_x.size(0)] + int(static_x.dim()) + k
    return z.cpu().item()


def eager(x):
    return x.item(), x.cpu(), float(x), x.tolist()


def report(struct):
    return float(struct.sum())


class Runner:
    def run(self, graph, struct):
        graph.capture(lambda: struct * 2, [])
        out = self._run_step(("k",), struct, lambda s: s + 1)
        torch.cuda.synchronize()
        return report(out), graph.replay()
