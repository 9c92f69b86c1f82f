"""A pool of spawned CPU ranks for the port's multi-rank tests.

`RankPool(n)` starts `n` processes once (a module-scoped fixture holds
it); `run(job, world, **kwargs)` has ranks 0..world-1 form a fresh gloo
process group on a free local port, call `job` (a function of
`tests/_torch_jobs.py`, by name) with their rank and `kwargs`, leave the
group, and send back what it returned (numpy arrays, numbers, dicts).
The ranks import torch and the port only: the JAX reference runs in the
test process. A job that raises fails `run` with the rank's traceback.
"""
from __future__ import annotations

import multiprocessing as mp
import os
import socket
import traceback


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, inbox, outbox):
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    import _torch_jobs
    while True:
        msg = inbox.get()
        if msg is None:
            return
        job, world, port, kwargs = msg
        if rank >= world:
            outbox.put((rank, True, None))
            continue
        try:
            dist.init_process_group(
                "gloo", init_method=f"tcp://127.0.0.1:{port}",
                world_size=world, rank=rank)
            try:
                out = getattr(_torch_jobs, job)(rank, world, **kwargs)
            finally:
                dist.destroy_process_group()
            outbox.put((rank, True, out))
        except BaseException:       # noqa: BLE001 — reported to the test
            outbox.put((rank, False, traceback.format_exc()))


class RankPool:
    def __init__(self, n: int):
        ctx = mp.get_context("spawn")
        here = os.path.dirname(os.path.abspath(__file__))
        repo = os.path.dirname(here)
        path = os.environ.get("PYTHONPATH", "")
        os.environ["PYTHONPATH"] = os.pathsep.join(
            p for p in (here, repo, path) if p)
        self.n = n
        self._out = ctx.Queue()
        self._ins = [ctx.Queue() for _ in range(n)]
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, self._ins[r], self._out),
                                   daemon=True) for r in range(n)]
        for p in self._procs:
            p.start()
        os.environ["PYTHONPATH"] = path

    def run(self, job: str, world: int, timeout: float = 240.0, **kwargs):
        """Per-rank results of `job` on a `world`-rank group."""
        if world > self.n:
            raise ValueError(f"pool of {self.n} ranks, {world} asked")
        port = _free_port()
        for q in self._ins:
            q.put((job, world, port, kwargs))
        import queue
        import time
        got = {}
        deadline = time.monotonic() + timeout
        while len(got) < self.n:
            try:
                rank, ok, out = self._out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in got]
                if dead or time.monotonic() > deadline:
                    raise RuntimeError(f"ranks {dead or 'all'} gave no "
                                       f"result for {job}")
                continue
            got[rank] = (ok, out)
        errors = [f"rank {r}:\n{out}" for r, (ok, out) in sorted(got.items())
                  if not ok]
        if errors:
            raise RuntimeError("\n".join(errors))
        return [got[r][1] for r in range(world)]

    def close(self):
        for q in self._ins:
            q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()


# ------------------------------------------------ the reference's side
# (imported by the test process only: the ranks never import jax)
def blobs(n=96, k=4, d=8, seed=0, dtype="float32"):
    """Separable blobs: (X (n, d), one-hot Y (n, k))."""
    import numpy as np
    rs = np.random.RandomState(seed)
    X = np.vstack([rs.randn(n // k, d) * 0.35 + i for i in range(k)]
                  ).astype(dtype)
    Y = np.eye(k, dtype=dtype)[np.repeat(np.arange(k), n // k)]
    perm = rs.permutation(n)
    return X[perm], Y[perm]


def ref_mlp(seed=7, lr=5e-2, clip=None, dtype="float32", width=16,
            updater=None, constraint=False, dropout=0.0):
    """The reference's 8-16-4 MLP conf (Adam; optional global-norm clip,
    max-norm constraint, input dropout on the hidden layer, dtype)."""
    import dataclasses

    from deeplearning4j_tpu.nn.conf.base import InputType
    from deeplearning4j_tpu.nn.conf.network import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.updaters import Adam
    b = NeuralNetConfiguration.Builder().seed(seed).updater(
        updater or Adam(lr))
    if clip is not None:
        b = b.grad_clip_norm(clip)
    kw = {}
    if constraint:
        from deeplearning4j_tpu.nn.regularization import MaxNormConstraint
        kw["constraints"] = (MaxNormConstraint(max_norm=0.5),)
    conf = (b.list()
            .layer(DenseLayer(n_out=width, activation="relu",
                              dropout=dropout, **kw))
            .layer(OutputLayer(n_out=4, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(8)).build())
    return dataclasses.replace(conf, dtype=dtype) if dtype != "float32" \
        else conf


def ref_graph(seed=9, lr=5e-2):
    """The reference's single-input single-output graph: dense, output."""
    from deeplearning4j_tpu.nn.conf.base import InputType
    from deeplearning4j_tpu.nn.conf.network import (
        GraphBuilder, NeuralNetConfiguration,
    )
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.nn.updaters import Adam
    g = (GraphBuilder(NeuralNetConfiguration.Builder().seed(seed)
                      .updater(Adam(lr)))
         .add_inputs("in").set_input_types(InputType.feed_forward(8)))
    g.add_layer("d", DenseLayer(n_out=16, activation="tanh"), "in")
    g.add_layer("out", OutputLayer(n_out=4, activation="softmax",
                                   loss="mcxent"), "d")
    g.set_outputs("out")
    return g.build()


def save_ref(conf, path, graph=False):
    """A reference network of `conf`, initialized and saved: the zip both
    sides load."""
    from deeplearning4j_tpu.util.serialization import save_model
    if graph:
        from deeplearning4j_tpu.nn.graph import ComputationGraph as C
    else:
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as C
    save_model(C(conf).init(), str(path))
    return str(path)


def ref_mesh(data, model=1):
    """The reference's mesh over the first data x model of the 8 CPU
    devices the conftest forces."""
    import jax

    from deeplearning4j_tpu.parallel import MeshConfig, build_mesh
    return build_mesh(MeshConfig(data=data, model=model),
                      devices=jax.devices()[:data * model])


def ref_plan(data, model=1, megatron=False, zero_stage=0):
    from deeplearning4j_tpu.parallel import ShardingPlan, ShardingRules
    return ShardingPlan.for_mesh(
        ref_mesh(data, model),
        rules=ShardingRules.megatron() if megatron else None,
        zero_stage=zero_stage)


def ref_source(net, X, Y, batch):
    """The reference container's iterator over (X, Y)."""
    from deeplearning4j_tpu.data.dataset import MultiDataSet
    from deeplearning4j_tpu.data.iterator import ArrayDataSetIterator
    from deeplearning4j_tpu.nn.graph import ComputationGraph
    if isinstance(net, ComputationGraph):
        return [MultiDataSet((X[i:i + batch],), (Y[i:i + batch],), None,
                             None) for i in range(0, len(X), batch)]
    return ArrayDataSetIterator(X, Y, batch_size=batch)


def ref_flat(net):
    import numpy as np
    return np.asarray(net.params_flat())


def assert_params_close(port, ref, f64=False):
    """The stated tolerance: 1e-5 relative in f32 (1e-10 in f64), with an
    absolute floor of 1e-7 (1e-13) for entries near zero."""
    import numpy as np
    rtol, atol = (1e-10, 1e-13) if f64 else (1e-5, 1e-7)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=atol)
