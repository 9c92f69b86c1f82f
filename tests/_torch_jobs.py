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


# ------------------------------------------- sequence and pipeline slice
def mesh_coords4(rank, world, data, stage=1, seq=1, model=1):
    """This rank's coordinates on the four axes, each axis group's ranks
    and those of the (data, seq) and (data, stage) groups."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import MeshConfig, build_mesh
    mesh = build_mesh(MeshConfig(data=data, stage=stage, seq=seq,
                                 model=model))
    axes = ("data", "stage", "seq", "model")
    groups = {a: dist.get_process_group_ranks(mesh.group(a)) for a in axes}
    for combo in (("data", "seq"), ("data", "stage")):
        groups["+".join(combo)] = dist.get_process_group_ranks(
            mesh.group(combo))
    return {"coords": [mesh.index(a) for a in axes], "groups": groups,
            "shape": dict(mesh.shape)}


def ring_attention(rank, world, data, seq, q, k, v, w, mask=None,
                   causal=True, impl="online", block=8, device="cpu"):
    """make_ring_attention (impl "online") or the flash ring through the
    same global wrapper (impl "flash"), on the global (B, T, H, D)
    inputs: the output, the gradients of sum(out * w) with respect to q,
    k and v, the rotation counters and the metric counters."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.parallel import (
        MeshConfig, build_mesh, make_ring_attention,
    )
    from deeplearning4j_tpu_torch.parallel import ring as R
    mesh = build_mesh(MeshConfig(data=data, seq=seq))
    R.reset_transfers()
    names = ("ring_attention_calls_total", "ring_bytes_rotated_total")

    def values():
        dump = monitor.dump()
        return [sum(s["value"] for s in dump.get(n, {}).get("series", ()))
                for n in names]
    before = values()
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    launched = dict(fa.KERNEL_LAUNCHES)
    qt, kt, vt = (torch.tensor(a, device=device, requires_grad=True)
                  for a in (q, k, v))
    mt = None if mask is None else torch.tensor(mask, device=device)
    if impl == "online":
        out = make_ring_attention(mesh, causal=causal)(qt, kt, vt, mt)
    else:
        ring = R.Ring.of(mesh)
        n = q.shape[1] // ring.size
        loc = [R._ShardSeq.apply(a, ring) for a in (qt, kt, vt)]
        ml = None if mt is None else mt.narrow(1, ring.index * n, n)
        out = R._GatherSeq.apply(R.ring_flash_self_attention(
            *loc, ring=ring, causal=causal, mask=ml, block_q=block,
            block_k=block), ring)
    grads = torch.autograd.grad((out * torch.tensor(w, device=device))
                                .sum(), (qt, kt, vt))
    return {"out": out.detach().cpu().numpy(),
            "grads": [g.cpu().numpy() for g in grads],
            "launches": {n: fa.KERNEL_LAUNCHES[n] - launched[n]
                         for n in launched},
            "transfers": {k2: v2 for k2, v2 in R.TRANSFERS.items()
                          if k2 != "seconds"},
            "metrics": {n: a - b for n, a, b in zip(names, values(),
                                                    before)}}


def ring_gradcheck(rank, world, seq, q, k, v, w, mask=None, causal=True):
    """The port's gradientcheck (f64 central differences) over q of the
    ring through make_ring_attention: every rank checks the same entries
    of the global q."""
    from deeplearning4j_tpu_torch.gradientcheck import check_gradients
    from deeplearning4j_tpu_torch.parallel import (
        MeshConfig, build_mesh, make_ring_attention,
    )
    attend = make_ring_attention(build_mesh(MeshConfig(seq=seq)),
                                 causal=causal)
    kt, vt, wt = (torch.tensor(a) for a in (k, v, w))
    mt = None if mask is None else torch.tensor(mask)

    class Probe:
        device = torch.device("cpu")
        params = {"q": torch.tensor(q)}
        state = {}
        _compute_dtype = _param_dtype = torch.float64

        def _score_fn(self, p, state, x, y, fm, lm, train):
            return (attend(p["q"], kt, vt, mt) * wt).sum(), None

    res = check_gradients(Probe(), np.zeros(1), np.zeros(1),
                          max_per_param=24, eps=1e-6, max_rel_error=1e-6)
    return {"passed": res.passed, "max_rel_error": res.max_rel_error,
            "checked": res.n_params_checked}


def _lm_source(net, X, Y, batch, fmask=None, lmask=None):
    from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    cut = (lambda a, i: None if a is None else a[i:i + batch])
    if isinstance(net, ComputationGraph):
        return [MultiDataSet(
            (X[i:i + batch],), (Y[i:i + batch],),
            None if fmask is None else (cut(fmask, i),),
            None if lmask is None else (cut(lmask, i),))
            for i in range(0, len(X), batch)]
    return ExistingDataSetIterator([
        DataSet(X[i:i + batch], Y[i:i + batch], cut(fmask, i),
                cut(lmask, i)) for i in range(0, len(X), batch)])


def context_fit(rank, world, zip_path, X, Y, batch, data=1, seq=1,
                fmask=None, lmask=None, device="cpu"):
    """ContextParallelTrainer over a (data, seq) mesh: the flat params,
    the scores, the kernel launches and the ring's transfers."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import (
        ContextParallelTrainer, MeshConfig, build_mesh,
    )
    from deeplearning4j_tpu_torch.parallel import ring as R
    from deeplearning4j_tpu_torch.util.serialization import load_model
    if device == "cuda":
        from deeplearning4j_tpu_torch.util.platform import (
            set_f32_matmul_exact,
        )
        set_f32_matmul_exact()
    net = load_model(zip_path, device=device)
    sc = _Scores()
    net.set_listeners(sc)
    t = ContextParallelTrainer(net, build_mesh(MeshConfig(data=data,
                                                          seq=seq)))
    R.reset_transfers()
    for kname in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[kname] = 0
    t.fit(_lm_source(net, X, Y, batch, fmask, lmask), epochs=1,
          batch_size=batch)
    return {"flat": net.params_flat().detach().cpu().numpy().copy(),
            "scores": sc.vals, "iterations": net.iteration_count,
            "syncs": t.syncs, "launches": dict(fa.KERNEL_LAUNCHES),
            "routes": dict(R.TRANSFERS["routes"])}


def pipeline_fit(rank, world, zip_path, X, Y, batch, data=1, stage=2,
                 n_microbatches=None, fmask=None, lmask=None,
                 device="cpu"):
    """PipelineParallelTrainer over a (data, stage) mesh: the flat params,
    the scores, the kernel launches and the ring's transfers."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import (
        MeshConfig, PipelineParallelTrainer, build_mesh,
    )
    from deeplearning4j_tpu_torch.parallel import ring as R
    from deeplearning4j_tpu_torch.util.serialization import load_model
    if device == "cuda":
        from deeplearning4j_tpu_torch.util.platform import (
            set_f32_matmul_exact,
        )
        set_f32_matmul_exact()
    net = load_model(zip_path, device=device)
    sc = _Scores()
    net.set_listeners(sc)
    t = PipelineParallelTrainer(
        net, build_mesh(MeshConfig(data=data, stage=stage)),
        n_microbatches=n_microbatches)
    R.reset_transfers()
    for kname in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[kname] = 0
    t.fit(_lm_source(net, X, Y, batch, fmask, lmask), epochs=1,
          batch_size=batch)
    return {"flat": net.params_flat().detach().cpu().numpy().copy(),
            "scores": sc.vals, "iterations": net.iteration_count,
            "syncs": t.syncs, "launches": dict(fa.KERNEL_LAUNCHES),
            "routes": dict(R.TRANSFERS["routes"]),
            "blocks": t.my_blocks}


# ------------------------------------------ tensor- and expert-parallel slice
def _model_group():
    from deeplearning4j_tpu_torch.parallel import MeshConfig, build_mesh
    from deeplearning4j_tpu_torch.parallel import tensor as tp
    mesh = build_mesh(MeshConfig(data=1, model=torch.distributed
                                 .get_world_size()))
    return tp.ModelGroup(mesh.group("model"), mesh.shape["model"],
                         mesh.index("model"))


def tp_collectives(rank, world, x, pieces, g_whole, g_pieces):
    """Each function of `parallel/tensor.py` in f64, forward and backward:
    copy_to_model and model_slice on the whole `x`, reduce_from_model and
    gather_from_model on this rank's `pieces[rank]`; each backward from
    this rank's cotangent (`g_whole[rank]` or `g_pieces[rank]`)."""
    from deeplearning4j_tpu_torch.parallel import tensor as tp
    mg = _model_group()
    out = {}
    for name, fn, inp, g in (
            ("copy", lambda t: tp.copy_to_model(t, mg), x, g_whole),
            ("slice", lambda t: tp.model_slice(t, mg, -1), x, g_pieces),
            ("reduce", lambda t: tp.reduce_from_model(t, mg), pieces[rank],
             g_pieces),
            ("gather", lambda t: tp.gather_from_model(t, mg, -1),
             pieces[rank], g_whole)):
        t = torch.tensor(inp, requires_grad=True)
        y = fn(t)
        (grad,) = torch.autograd.grad(y, t, torch.tensor(g[rank]))
        out[name] = (y.detach().numpy(), grad.numpy())
    return out


def tp_gradcheck(rank, world, x, w1, w2, w3, w):
    """The port's gradientcheck (f64 central differences) through all four
    functions: a column-parallel product, a row-parallel one and a
    column-parallel one gathered whole, on whole leaves every rank holds
    (sliced by `model_slice`)."""
    from deeplearning4j_tpu_torch.gradientcheck import check_gradients
    from deeplearning4j_tpu_torch.parallel import tensor as tp
    mg = _model_group()
    wt = torch.tensor(w)

    class Probe:
        device = torch.device("cpu")
        params = {k: torch.tensor(v) for k, v in
                  (("x", x), ("w1", w1), ("w2", w2), ("w3", w3))}
        state = {}
        _compute_dtype = _param_dtype = torch.float64

        def _score_fn(self, p, state, xx, y, fm, lm, train):
            h = torch.tanh(tp.copy_to_model(p["x"], mg)
                           @ tp.model_slice(p["w1"], mg, -1))
            z = tp.reduce_from_model(h @ tp.model_slice(p["w2"], mg, 0), mg)
            z = tp.gather_from_model(tp.copy_to_model(torch.tanh(z), mg)
                                     @ tp.model_slice(p["w3"], mg, -1), mg)
            return (z * wt).sum(), None

    res = check_gradients(Probe(), np.zeros(1), np.zeros(1),
                          max_per_param=64, eps=1e-6, max_rel_error=1e-6)
    return {"passed": res.passed, "max_rel_error": res.max_rel_error,
            "checked": res.n_params_checked}


def tp_fit(rank, world, zip_path, X, Y, batch, plan, fmask=None, lmask=None,
           accumulate_steps=1, ledger=False, use_mesh=False, wrapper=False):
    """net.fit(plan=) of a model zip (an LM when masks or 3-D labels
    come): the flat params, the scores, what the forward was handed (the
    shapes of the first `forward_params`), how often `full_params` ran
    before the fit's end, the ledger's FLOPs of the step, the syncs and
    the plan's warnings. With `wrapper`, a ParallelWrapper built under
    use_mesh(plan) runs the fit."""
    import logging

    from deeplearning4j_tpu_torch.monitor import xla as ledger_mod
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    from deeplearning4j_tpu_torch.parallel import plan as plan_mod
    from deeplearning4j_tpu_torch.parallel import use_mesh as um
    from deeplearning4j_tpu_torch.util.serialization import load_model
    net = load_model(zip_path, device="cpu")
    sc = _Scores()
    net.set_listeners(sc)
    seen = {"forward": None, "full_calls": 0, "warnings": []}
    real_fwd = plan_mod.PlanRuntime.forward_params
    real_full = plan_mod.PlanRuntime.full_params

    def forward_params(self, params):
        out = real_fwd(self, params)
        if seen["forward"] is None:
            seen["forward"] = {p: tuple(t.shape)
                               for p, t in plan_mod._paths(out)}
        return out

    def full_params(self, params):
        seen["full_calls"] += 1
        return real_full(self, params)

    class Catch(logging.Handler):
        def emit(self, record):
            seen["warnings"].append(record.getMessage())
    catch = Catch(logging.WARNING)
    logger = logging.getLogger("deeplearning4j_tpu_torch")
    logger.addHandler(catch)
    plan_mod._warned_model_compute.clear()
    plan_mod.PlanRuntime.forward_params = forward_params
    plan_mod.PlanRuntime.full_params = full_params
    full_at_end = []

    class AtStep(_Scores):
        def iteration_done(self, n, it, ep, score, etl_ms, bs):
            full_at_end[:] = [seen["full_calls"]]
            if "opt" not in seen:
                seen["opt"] = [tuple(t.shape)
                               for t in tree_leaves(n.opt_state)]
    net.add_listeners(AtStep())
    if ledger:
        ledger_mod.clear_ledger()
        ledger_mod.enable_ledger()
    p = _plan(plan)
    src = _lm_source(net, X, Y, batch, fmask, lmask) if X.ndim == 3 \
        else _source(net, X, Y, batch)
    adopted = None
    try:
        if wrapper:
            from deeplearning4j_tpu_torch.parallel import ParallelWrapper
            with um(p):
                w = ParallelWrapper(net)
                adopted = {"model": w.plan.model_degree,
                           "zero_stage": w.zero_stage}
            w.fit(src, epochs=1, batch_size=batch)
        elif use_mesh:
            with um(p):
                net.fit(src, epochs=1, accumulate_steps=accumulate_steps)
        else:
            net.fit(src, epochs=1, plan=p,
                    accumulate_steps=accumulate_steps)
    finally:
        plan_mod.PlanRuntime.forward_params = real_fwd
        plan_mod.PlanRuntime.full_params = real_full
        logger.removeHandler(catch)
        if ledger:
            ledger_mod.disable_ledger()
    flops = None
    if ledger:
        recs = [r for r in ledger_mod.records() if r.name.endswith(
            "train_step")]
        flops = recs[0].flops if recs else None
    return {"flat": _flat(net), "scores": sc.vals,
            "iterations": net.iteration_count,
            "forward": seen["forward"], "opt": seen.get("opt"),
            "full_calls_in_fit": full_at_end[0] if full_at_end else None,
            "warnings": seen["warnings"], "flops": flops,
            "syncs": net._plan_syncs, "wrapper": adopted}


def tp_infer(rank, world, zip_path, X, plan, batches=(8, 5),
             mode="sequential"):
    """ParallelInference(net, plan=) on every rank, each calling output()
    with the same batches; then update_model to a second copy of the zip
    and the same batches again."""
    from deeplearning4j_tpu_torch.parallel import ParallelInference
    from deeplearning4j_tpu_torch.util.serialization import load_model
    net = load_model(zip_path, device="cpu")
    pi = ParallelInference(net, plan=_plan(plan), mode=mode)
    shapes = {p: tuple(t.shape) for p, t in
              __import__("deeplearning4j_tpu_torch.parallel.plan",
                         fromlist=["_paths"])._paths(net.params)}
    outs = [pi.output(X[:n]) for n in batches]
    warmed = []
    pi.update_model(load_model(zip_path, device="cpu"),
                    warmup=lambda run: warmed.append(run(X[:2]).shape))
    outs2 = [pi.output(X[:n]) for n in batches]
    pi.shutdown()
    return {"outs": outs, "outs2": outs2, "warmed": warmed,
            "stored": shapes}


def tp_deploy(rank, world, source, X, plan, swap_to=None):
    """ModelRegistry.deploy(name, source, plan=) on every rank: rank 0
    predicts through the servable's batcher (then swaps to `swap_to` and
    predicts again, when given) and shuts down; the other ranks follow
    until then. Returns rank 0's answers, the followers' forward count."""
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    reg = ModelRegistry(device="cpu")
    served = reg.deploy("lm", source, buckets=(1, 4), plan=_plan(plan))
    if rank != 0:
        status = served.status
        runs = served.follow()
        return {"runs": runs, "status": status,
                "version": served.versions[served.active].version}
    outs = [served.predict(X[:n]) for n in (1, 3)]
    outs_swapped = None
    if swap_to is not None:
        served.swap(swap_to)
        outs_swapped = [served.predict(X[:n]) for n in (1, 3)]
    reg.shutdown()
    return {"outs": outs, "outs_swapped": outs_swapped,
            "role": served.pi.role}


def tp_engage_errors(rank, world, models, plan):
    """Engage `plan` on each zoo model ((name, kwargs) pairs): the
    ValueError each raised, None where it engaged."""
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    out = []
    for name, kw in models:
        net = model_by_name(name, **kw).init(device="cpu")
        try:
            net._engage_plan(_plan(plan))
        except ValueError as e:
            out.append(str(e))
            continue
        net._engage_plan(None)
        out.append(None)
    return out


def tp_deploy_rejects(rank, world, source, X, plan, missing, wrong_shape,
                      follower_fails, good):
    """deploy(plan=) on every rank, then swaps that fail, each followed by
    rank 0's predicts: a `missing` source and a `wrong_shape` one (the
    leader's load or check fails), `follower_fails` (rank 1's load of it
    raises), a rollback with no previous version, and a swap to `good`
    whose warm-up fails on the leader; then the swap to `good`. Returns
    rank 0's errors and answers, every rank's versions and the followers'
    forward count."""
    from deeplearning4j_tpu_torch.serving import registry
    real_load = registry.load_servable
    if rank != 0:
        def load(src, device=None):
            if str(src) == follower_fails:
                raise registry.ModelLoadError("not on this rank")
            return real_load(src, device=device)
        registry.load_servable = load
    reg = registry.ModelRegistry(device="cpu")
    served = reg.deploy("lm", source, buckets=(1, 4), plan=_plan(plan))

    def versions():
        return [v.version for v in served.versions], \
            served.versions[served.active].version
    if rank != 0:
        runs = served.follow()
        return {"runs": runs, "versions": versions()}
    errors, outs = [], []

    def attempt(fn):
        try:
            fn()
            errors.append(None)
        except Exception as e:
            errors.append(f"{type(e).__name__}: {e}")
        outs.append(served.predict(X[:3]))
    attempt(lambda: served.swap(missing))
    attempt(lambda: served.swap(wrong_shape))
    attempt(lambda: served.swap(follower_fails))
    attempt(served.rollback)
    warm = served.batcher.warm

    def broken_warm(run=None):
        raise RuntimeError("warm-up failed")
    served.batcher.warm = broken_warm
    attempt(lambda: served.swap(good))
    served.batcher.warm = warm
    attempt(lambda: served.swap(good))
    reg.shutdown()
    return {"errors": errors, "outs": outs, "versions": versions()}


def tp_resilient(rank, world, zip_path, X, Y, batch, ckpt_dir, epochs, plan,
                 preempt_at=None):
    """ResilientTrainer under use_mesh(plan), preempted at `preempt_at`
    when given: the params and the report."""
    from deeplearning4j_tpu_torch.parallel import use_mesh
    from deeplearning4j_tpu_torch.train.resilience import ResilientTrainer
    from deeplearning4j_tpu_torch.util.faults import FaultInjector
    from deeplearning4j_tpu_torch.util.serialization import load_model
    net = load_model(zip_path, device="cpu")
    inj = FaultInjector(preempt_at=preempt_at) \
        if preempt_at is not None else None
    with use_mesh(_plan(plan)):
        rep = ResilientTrainer(net, ckpt_dir, save_every_n_iterations=2,
                               injector=inj).fit(
            _source(net, X, Y, batch), epochs=epochs, batch_size=batch)
    return {"flat": _flat(net), "preempted": rep.preempted,
            "resumed_from": rep.resumed_from,
            "iterations": net.iteration_count}


def stats_plan(rank, world, zip_path, X, Y, batch, plan):
    """fit(plan=) with a StatsListener: each record's gradient and update
    summaries (whole trees, gathered from the rank's pieces)."""
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, StatsListener
    from deeplearning4j_tpu_torch.util.serialization import load_model
    net = load_model(zip_path, device="cpu")
    st = InMemoryStatsStorage()
    net.set_listeners(StatsListener(st, session_id="p"))
    net.fit(_source(net, X, Y, batch), plan=_plan(plan))
    return [{g: r.data[g] for g in ("gradients", "updates")}
            for r in st.get_all_updates_after("p", "StatsListener",
                                              "worker-0", 0)]


def run_example(rank, world, name, kwargs=None):
    """One of the port's examples (`deeplearning4j_tpu_torch/examples/`)
    run by every rank of the group, on the CPU: its result."""
    import importlib
    mod = importlib.import_module(f"deeplearning4j_tpu_torch.examples.{name}")
    return float(mod.main(device="cpu", **(kwargs or {})))
