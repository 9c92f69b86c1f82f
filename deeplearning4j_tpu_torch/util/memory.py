"""Memory reports: analytic per-layer estimates and the measured step peak.

Counterpart of the JAX package's `util/memory.py` (DL4J
`nn/conf/memory/LayerMemoryReport.java:22` and `NetworkMemoryReport`).
The analytic model is the reference's, row for row:

    params          = bytes of the layer's parameter leaves
    updater_state   = bytes of the optimizer-state leaves tied to the layer
    activations     = batch x output_type.flat_size x dtype (forward)
    working (train) = 2x activations (+ a convolution's column buffers)

The reference adds the numbers XLA assigns to the compiled training step
(`memory_analysis()`, read without running it). PyTorch has no compiled
program to ask, so the port's "compiled" part is measured: one forward
and backward of the training step on zero inputs of the report's batch
size, with no update, under the CUDA caching allocator's peak counter
(the program ledger's accounting, `monitor/xla.py`). Parameters,
optimizer state, layer state, the dropout generator and the counters are
left as they were: the forward draws from a generator of its own, the
new layer state is dropped, and no gradient is applied. The result has
the reference's `hbm_stats` keys. Without CUDA there is no allocator
peak: `compiled` is None and `xla_analysis_unavailable_total{kind=
"memory"}` counts it, as the reference does on a backend without memory
analysis.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.nn.updaters import tree_leaves

log = logging.getLogger("deeplearning4j_tpu_torch")


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


@dataclasses.dataclass
class LayerMemoryReport:
    """One layer/vertex row (DL4J LayerMemoryReport analog)."""
    name: str
    layer_type: str
    params_bytes: int
    updater_state_bytes: int
    activation_bytes: int          # inference-time output residency
    working_bytes: int             # training-time (fwd + bwd residual)

    @property
    def total_train_bytes(self) -> int:
        return (self.params_bytes + self.updater_state_bytes +
                self.working_bytes)

    @property
    def total_inference_bytes(self) -> int:
        return self.params_bytes + self.activation_bytes


@dataclasses.dataclass
class NetworkMemoryReport:
    """Whole-network aggregation (DL4J NetworkMemoryReport analog) plus the
    measured step peak when available."""
    layers: List[LayerMemoryReport]
    batch_size: int
    input_bytes: int
    compiled: Optional[Dict[str, int]] = None   # measured, on CUDA

    @property
    def total_params_bytes(self) -> int:
        return sum(r.params_bytes for r in self.layers)

    @property
    def total_updater_bytes(self) -> int:
        return sum(r.updater_state_bytes for r in self.layers)

    @property
    def total_activation_bytes(self) -> int:
        return sum(r.activation_bytes for r in self.layers)

    @property
    def total_train_bytes(self) -> int:
        """Analytic peak-residency estimate for one training step."""
        return (self.input_bytes + self.total_params_bytes +
                self.total_updater_bytes +
                sum(r.working_bytes for r in self.layers) +
                # gradient buffer the updater consumes (params-sized)
                self.total_params_bytes)

    @property
    def total_inference_bytes(self) -> int:
        return (self.input_bytes + self.total_params_bytes +
                max((r.activation_bytes for r in self.layers), default=0))

    @property
    def compiled_total_bytes(self) -> Optional[int]:
        # one peak-residency formula across memory_report and the ledger
        from deeplearning4j_tpu_torch.monitor.xla import hbm_peak
        return hbm_peak(self.compiled)

    def summary(self) -> str:
        lines = [f"{'layer':<24}{'type':<22}{'params':>12}{'updater':>12}"
                 f"{'acts':>12}{'train':>12}"]
        for r in self.layers:
            lines.append(f"{r.name:<24}{r.layer_type:<22}"
                         f"{r.params_bytes:>12,}{r.updater_state_bytes:>12,}"
                         f"{r.activation_bytes:>12,}"
                         f"{r.total_train_bytes:>12,}")
        lines.append(f"analytic train total (batch={self.batch_size}): "
                     f"{self.total_train_bytes:,} bytes")
        if self.compiled:
            lines.append(f"measured step: {self.compiled} "
                         f"(total {self.compiled_total_bytes:,} bytes)")
        return "\n".join(lines)


def _scratch_bytes(layer, in_t, out_t, batch_size, dtype_size) -> int:
    """Layer-specific working scratch beyond activations: convolution
    lowering materializes im2col-style column buffers of
    batch x out_h x out_w x kernel_area x c_in (forward and again for the
    backward pass) — the term DL4J's ConvolutionLayer memory report
    models as its working memory."""
    kernel = getattr(layer, "kernel", None)
    if kernel is None or len(getattr(out_t, "shape", ())) != 3 \
            or "onvolution" not in type(layer).__name__:
        return 0     # pooling needs no column buffer
    out_h, out_w = out_t.shape[0], out_t.shape[1]
    c_in = in_t.shape[2] if len(in_t.shape) == 3 else in_t.features
    col = batch_size * out_h * out_w * kernel[0] * kernel[1] * c_in
    return 2 * col * dtype_size          # forward + backward col buffers


def _same_structure(node, params) -> bool:
    """Whether `node` mirrors the parameter subtree `params` leaf for leaf
    (keys and shapes)."""
    if isinstance(params, dict):
        return isinstance(node, dict) and set(node) == set(params) and all(
            _same_structure(node[k], params[k]) for k in params)
    return isinstance(node, torch.Tensor) \
        and tuple(node.shape) == tuple(params.shape)


def _split_opt_state_bytes(opt_state, params) -> Dict[str, int]:
    """Bytes of optimizer state attributable to each top-level param key.

    The port's optimizer state is optax's state-dict layout: a chain's
    states are a dict keyed by position, each moment a copy of the
    parameter tree. A dict counts as a moment when it mirrors the
    parameter tree leaf for leaf (a chain keyed "0", "1" has the keys of a
    two-layer network's parameters, not their leaves); everything else
    (step counts) lands under '__other__'."""
    per_key = {k: 0 for k in params}
    other = 0

    def walk(node):
        nonlocal other
        if isinstance(node, dict) and _same_structure(node, params):
            for k in node:
                per_key[k] += _tree_bytes(node[k])
            return
        if isinstance(node, dict):
            for c in node.values():
                walk(c)
            return
        if isinstance(node, (tuple, list)):
            for c in node:
                walk(c)
            return
        other += _tree_bytes(node)

    walk(opt_state)
    per_key["__other__"] = other
    return per_key


def build_memory_report(net, batch_size: int,
                        with_compiled: bool = True) -> NetworkMemoryReport:
    """Analytic and measured memory report for a MultiLayerNetwork or
    ComputationGraph (exposed as net.memory_report(batch_size))."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    if net.params is None:
        raise RuntimeError("init() the network before memory_report()")
    is_graph = isinstance(net, ComputationGraph)
    dtype_size = torch.empty((), dtype=net._compute_dtype).element_size()
    opt_split = _split_opt_state_bytes(net.opt_state, net.params)

    rows = []
    if is_graph:
        types = net._vertex_types or net._resolve_types()
        net._vertex_types = types
        input_bytes = sum(batch_size * t.flat_size * dtype_size
                          for t in net.conf.input_types)
        for name in net._topo:
            vd = net.conf.vertices[name]
            out_t = types[name]
            in_t = types[vd.inputs[0]]
            act = batch_size * out_t.flat_size * dtype_size
            p_bytes = _tree_bytes(net.params.get(name, {}))
            scratch = _scratch_bytes(vd.vertex, in_t, out_t, batch_size,
                                     dtype_size)
            rows.append(LayerMemoryReport(
                name=name, layer_type=type(vd.vertex).__name__,
                params_bytes=p_bytes,
                updater_state_bytes=opt_split.get(name, 0),
                activation_bytes=act, working_bytes=2 * act + scratch))
    else:
        types = net._resolve_types()     # per-layer INPUT types
        input_bytes = batch_size * net.conf.input_type.flat_size * dtype_size
        for i, layer in enumerate(net.layers):
            out_t = layer.output_type(types[i])
            act = batch_size * out_t.flat_size * dtype_size
            key = str(i)
            scratch = _scratch_bytes(layer, types[i], out_t, batch_size,
                                     dtype_size)
            rows.append(LayerMemoryReport(
                name=key, layer_type=type(layer).__name__,
                params_bytes=_tree_bytes(net.params.get(key, {})),
                updater_state_bytes=opt_split.get(key, 0),
                activation_bytes=act, working_bytes=2 * act + scratch))

    compiled = None
    if with_compiled:
        compiled = _measured_step_memory(net, batch_size)
    return NetworkMemoryReport(layers=rows, batch_size=batch_size,
                               input_bytes=input_bytes, compiled=compiled)


def _count_unavailable():
    """The degraded path is counted, not silent: visible on /metrics as
    xla_analysis_unavailable_total{kind="memory"}."""
    from deeplearning4j_tpu_torch.monitor import xla as xla_ledger
    xla_ledger.analysis_unavailable("memory")


def _zero_batch(net, batch_size, is_graph) -> tuple:
    """A batch struct of zeros at the report's batch size: the network's
    input shapes and its outputs' label shapes, on the device, in the
    compute dtype (zero ids for an embedding)."""
    def zeros(shape):
        return torch.zeros((batch_size,) + tuple(shape),
                           dtype=net._compute_dtype, device=net.device)
    if is_graph:
        types = net._vertex_types or net._resolve_types()
        return (tuple(zeros(t.shape) for t in net.conf.input_types),
                tuple(zeros(types[o].shape)
                      for o in net.conf.network_outputs), None, None)
    types = net._resolve_types()
    out_t = net.layers[-1].output_type(types[-1])
    return (zeros(net.conf.input_type.shape), zeros(out_t.shape), None,
            None)


def probe_step(net, batch_size: int):
    """One training forward and backward on zeros of `batch_size`, with no
    update: (loss, gradients, the zero batch). The dropout noise comes
    from a generator of its own and the new layer state is dropped, so
    the network (parameters, optimizer and layer state, its generator,
    its counters) is left as it was."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    struct = _zero_batch(net, batch_size, isinstance(net, ComputationGraph))
    generator = torch.Generator(device=net.device).manual_seed(0)
    loss, grads, _, _ = net._grad_struct(struct, generator)
    return loss, grads, struct


def _measured_step_memory(net, batch_size) \
        -> Optional[Dict[str, int]]:
    """`probe_step` under the allocator's peak counter: the reference's
    `hbm_stats` keys, the temporaries being the peak over what was
    allocated before the step, less the gradients (reported as the
    step's output). Errors of the step itself propagate; only a device
    without an allocator peak degrades to None."""
    dev = net.device
    if dev.type != "cuda":
        _count_unavailable()
        log.warning("measured step memory unavailable on %s: no allocator "
                    "peak outside CUDA", dev)
        return None
    from deeplearning4j_tpu_torch.monitor.xla import _nbytes
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    loss, grads, struct = probe_step(net, batch_size)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    out_bytes = _nbytes(grads) + _nbytes(loss)
    # the zero batch was allocated inside the window: it is an argument
    in_bytes = _nbytes(struct)
    return {
        "argument_bytes": int(_nbytes((net.params, net.opt_state, net.state))
                              + in_bytes),
        "output_bytes": int(out_bytes),
        "temp_bytes": int(max(peak - base - in_bytes - out_bytes, 0)),
        "alias_bytes": 0, "generated_code_bytes": 0}
