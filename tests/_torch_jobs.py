"""Jobs the spawned ranks of `tests/_torch_dist.py` run: each loads a
model zip on the CPU, trains it inside the rank's gloo group, and returns
numpy results. Imports torch and the port only."""
from __future__ import annotations

import numpy as np
import torch


def _flat(net) -> np.ndarray:
    return net.params_flat().detach().numpy().copy()


class _Scores:
    def __init__(self):
        self.vals = []

    def iteration_done(self, net, it, ep, score, etl_ms, bs):
        self.vals.append(score)

    def on_epoch_start(self, net, epoch):
        pass

    def on_epoch_end(self, net, epoch):
        pass


def _source(net, X, Y, batch, drop_last=True):
    """An iterator over (X, Y) in batches of `batch`, as the container
    reads it (a graph gets MultiDataSets)."""
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    if isinstance(net, ComputationGraph):
        return [MultiDataSet((X[i:i + batch],), (Y[i:i + batch],), None,
                             None) for i in range(0, len(X), batch)]
    return ArrayDataSetIterator(X, Y, batch_size=batch, drop_last=drop_last)


def _plan(kw):
    from deeplearning4j_tpu_torch.parallel import ShardingPlan, ShardingRules
    kw = dict(kw)
    if kw.pop("megatron", False):
        kw["rules"] = ShardingRules.megatron()
    if kw.pop("lm_rules", False):
        from deeplearning4j_tpu_torch.models.transformer import TransformerLM
        kw["rules"] = TransformerLM.sharding_rules()
    return ShardingPlan(**kw)


def fit_plan(rank, world, zip_path, X, Y, batch, epochs=1, plan=None,
             scan_steps=None, accumulate_steps=1, use_mesh=False,
             drop_last=True):
    """net.fit(plan=) (or under use_mesh): the trained flat params, the
    scores, the iteration count, and the syncs."""
    from deeplearning4j_tpu_torch.parallel import use_mesh as um
    from deeplearning4j_tpu_torch.util.serialization import load_model
    net = load_model(zip_path, device="cpu")
    sc = _Scores()
    net.set_listeners(sc)
    p = _plan(plan or {})
    src = _source(net, X, Y, batch, drop_last)
    kw = dict(epochs=epochs, scan_steps=scan_steps,
              accumulate_steps=accumulate_steps)
    if use_mesh:
        with um(p):
            net.fit(src, **kw)
    else:
        net.fit(src, plan=p, **kw)
    return {"flat": _flat(net), "scores": sc.vals,
            "iterations": net.iteration_count}


def wrapper_fit(rank, world, zip_path, X, Y, batch, epochs=1,
                mode="sync_gradients", averaging_frequency=5,
                average_updaters=True, zero_stage=0, plan=None,
                report_score_after_averaging=False):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.util.serialization import load_model
    net = load_model(zip_path, device="cpu")
    sc = _Scores()
    net.set_listeners(sc)
    w = ParallelWrapper(
        net, mode=mode, averaging_frequency=averaging_frequency,
        average_updaters=average_updaters, zero_stage=zero_stage,
        plan=None if plan is None else _plan(plan),
        report_score_after_averaging=report_score_after_averaging)
    w.fit(_source(net, X, Y, batch), epochs=epochs, batch_size=batch)
    return {"flat": _flat(net), "scores": sc.vals, "score": net.score(),
            "iterations": net.iteration_count, "n_workers": w.n_workers}


def resilient_wrapper(rank, world, zip_path, X, Y, batch, ckpt_dir, epochs,
                      preempt_at=None, save_every=2):
    """ResilientTrainer over a SYNC wrapper; preempted at `preempt_at`
    (the injector's step index) when given. Returns the report's fields
    and the params, and the files this rank finds in `ckpt_dir`."""
    import os

    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.train.resilience import ResilientTrainer
    from deeplearning4j_tpu_torch.util.faults import FaultInjector
    from deeplearning4j_tpu_torch.util.serialization import load_model
    net = load_model(zip_path, device="cpu")
    w = ParallelWrapper(net)
    inj = FaultInjector(preempt_at=preempt_at) if preempt_at is not None \
        else None
    t = ResilientTrainer(w, ckpt_dir, save_every_n_iterations=save_every,
                         injector=inj)
    rep = t.fit(_source(net, X, Y, batch), epochs=epochs, batch_size=batch)
    return {"flat": _flat(net), "preempted": rep.preempted,
            "resumed_from": rep.resumed_from,
            "written": rep.checkpoints_written,
            "iterations": net.iteration_count,
            "files": sorted(os.listdir(ckpt_dir))}


def placement(rank, world, zip_path, plan, X, Y, batch):
    """Shapes a rank stores during a fit under `plan`: the parameters and
    the optimizer moments, read by a listener at the first step; and the
    plan's warnings."""
    import logging

    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    from deeplearning4j_tpu_torch.parallel import plan as plan_mod
    from deeplearning4j_tpu_torch.util.serialization import load_model
    net = load_model(zip_path, device="cpu")
    seen = {"warnings": []}

    class Catch(logging.Handler):
        def emit(self, record):
            seen["warnings"].append(record.getMessage())
    catch = Catch(logging.WARNING)
    logger = logging.getLogger("deeplearning4j_tpu_torch")
    logger.addHandler(catch)
    plan_mod._warned_model_compute.clear()   # once per process: re-arm

    class Probe(_Scores):
        def iteration_done(self, n, it, ep, score, etl_ms, bs):
            if "params" not in seen:
                seen["params"] = {k: {pk: tuple(v.shape)
                                      for pk, v in d.items()}
                                  for k, d in n.params.items()}
                seen["opt"] = [tuple(t.shape)
                               for t in tree_leaves(n.opt_state)]
    net.set_listeners(Probe())
    try:
        net.fit(_source(net, X, Y, batch), plan=_plan(plan))
    finally:
        logger.removeHandler(catch)
    seen["after"] = {k: {pk: tuple(v.shape) for pk, v in d.items()}
                     for k, d in net.params.items()}
    seen["opt_after"] = [tuple(t.shape) for t in tree_leaves(net.opt_state)]
    return seen


def gloo_ops(rank, world):
    """The collectives the port issues, on CPU tensors."""
    import torch.distributed as dist
    t = torch.full((3,), float(rank))
    dist.all_reduce(t)
    out = torch.empty(3 * world)
    dist.all_gather_into_tensor(out, torch.full((3,), float(rank)))
    return t.numpy(), out.numpy()


def shared_socket(rank, world, zip_path, X, Y, batch, base_port, epochs=2,
                  threshold=5e-4):
    """SharedGradientsTrainer as worker `rank` of `world` OS processes over
    SocketTransport: the flat params, the scores, the wire counters."""
    from deeplearning4j_tpu_torch.parallel import (
        SharedGradientsTrainer, SocketTransport,
    )
    from deeplearning4j_tpu_torch.util.serialization import load_model
    net = load_model(zip_path, device="cpu")
    sc = _Scores()
    net.set_listeners(sc)
    with SocketTransport(rank=rank, n_workers=world,
                         base_port=base_port) as transport:
        t = SharedGradientsTrainer(net, n_workers=world, threshold=threshold,
                                   rank=rank, transport=transport)
        t.fit(_source(net, X, Y, batch), epochs=epochs, batch_size=batch)
        return {"flat": _flat(net), "scores": sc.vals,
                "bytes_sent": transport.bytes_sent,
                "messages_sent": transport.messages_sent,
                "compression_ratio": t.compression_ratio()}


def mesh_coords(rank, world, data, model):
    """This rank's (data, model) coordinates and its groups' ranks."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import MeshConfig, build_mesh
    from deeplearning4j_tpu_torch.parallel.distributed import (
        is_coordinator, process_count, process_index,
    )
    mesh = build_mesh(MeshConfig(data=data, model=model))
    return {"coords": (mesh.index("data"), mesh.index("model")),
            "data_group": dist.get_process_group_ranks(mesh.group("data")),
            "model_group": dist.get_process_group_ranks(
                mesh.group("model")),
            "index": process_index(), "count": process_count(),
            "coordinator": is_coordinator(), "shape": dict(mesh.shape)}


def resilient_plan(rank, world, zip_path, X, Y, batch, ckpt_dir, epochs,
                   zero_stage, preempt_at=None):
    """ResilientTrainer over the network under use_mesh(ShardingPlan(
    data=world, zero_stage)): the params, the log's warnings, and the
    newest checkpoint's banked plan."""
    import logging

    from deeplearning4j_tpu_torch.parallel import ShardingPlan, use_mesh
    from deeplearning4j_tpu_torch.train.resilience import (
        CheckpointManager, ResilientTrainer,
    )
    from deeplearning4j_tpu_torch.util.faults import FaultInjector
    from deeplearning4j_tpu_torch.util.serialization import load_model

    class Grab(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.messages = []

        def emit(self, record):
            self.messages.append(record.getMessage())

    grab = Grab()
    log = logging.getLogger("deeplearning4j_tpu_torch")
    log.addHandler(grab)
    try:
        net = load_model(zip_path, device="cpu")
        inj = FaultInjector(preempt_at=preempt_at) \
            if preempt_at is not None else None
        with use_mesh(ShardingPlan(data=world, zero_stage=zero_stage)):
            rep = ResilientTrainer(net, ckpt_dir, save_every_n_iterations=2,
                                   injector=inj).fit(
                _source(net, X, Y, batch), epochs=epochs, batch_size=batch)
    finally:
        log.removeHandler(grab)
    entry = CheckpointManager(ckpt_dir).latest_valid()
    extra = None
    if entry is not None:
        extra = CheckpointManager(ckpt_dir).restore_into(
            load_model(zip_path, device="cpu"), entry["path"])
    return {"flat": _flat(net), "preempted": rep.preempted,
            "resumed_from": rep.resumed_from, "warnings": grab.messages,
            "banked_plan": None if extra is None else extra.get("plan"),
            "iterations": net.iteration_count,
            "opt_shapes": [tuple(t.shape) for t in
                           __import__("deeplearning4j_tpu_torch.nn.updaters",
                                      fromlist=["tree_leaves"]).tree_leaves(
                               net.opt_state)]}
