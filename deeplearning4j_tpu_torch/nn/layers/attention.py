"""Attention / transformer layers.

Counterpart of the JAX package's `nn/layers/attention.py`: the same
configs (fields, defaults, serde names), the same parameter trees
((in, out) weights applied as ``x @ W``) and the same math, on torch
tensors. Activations are (B, T, F); heads are (B, T, H, D). Masks follow
DL4J semantics: (B, T) 0/1, masked steps neither attend nor are attended
to, and their outputs are zeroed.

`MultiHeadAttention` with ``attention_impl`` "flash" or "blockwise" and no
dropout runs `ops.flash_attention`, which launches the Hopper kernels on a
CUDA tensor (the forward, and in the backward the dQ and dK/dV kernels)
and uses their plain versions on a CPU tensor.

Context-parallel mode (`context_parallel`, entered by
`parallel/context.ContextParallelTrainer`): the time axis is sharded over
the mesh's ``seq`` group, so attention runs the ring
(`parallel/ring.py`): `ring_flash_self_attention` (the flash kernels per
shard pair, merged by their LSEs) where the flash path would run, else
`ring_self_attention` (dropout); RoPE positions and
`PositionalEmbeddingLayer`'s rows are offset by the shard's global start.

Tensor- and expert-parallel mode: under a sharding plan whose rules
split these layers' kernels over ``model`` (`TransformerLM.
sharding_rules()`; `parallel/plan.PlanRuntime`), each rank is handed its
pieces and computes with them (`parallel/tensor.py`). The attention's
Q/K/V projections are column-parallel, so a rank computes its
``n_heads / model`` heads (the flash kernel runs on those), and ``Wo`` is
row-parallel, its partial products summed over ``model`` before ``bo``;
the block's MLP is column-parallel up (``b1`` sliced) and row-parallel
down (``b2`` after the sum); the MoE's experts are split on their
leading dim, each rank scoring every expert's gate and running its own
experts; the embedding looks up the rank's vocabulary rows (ids outside
give zeros) or its columns, then sums or gathers over ``model``. Which
split a layer runs is read off the shapes it is handed.

Training draws its dropout masks from an explicit `torch.Generator` on the
activations' device (the reference splits a JAX key per layer; the two
streams differ, so parity tests run dropout-free or compare
distributions). Input dropout (`dropout`) applies where the reference
applies it: `MultiHeadAttention` and the output head; `TransformerBlock`
adds its residual dropout. Attention-probability dropout in training runs
the plain product (the kernels draw no masks), as the reference runs its
blockwise path.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, Kind, LayerConf, dropout, register_layer, uniform,
)
from deeplearning4j_tpu_torch.nn.initializers import get_initializer
from deeplearning4j_tpu_torch.nn.step_graph import check_ids
from deeplearning4j_tpu_torch.parallel import tensor as tp

NEG = -1e30
COLUMN = (None, tp.MODEL)       # a kernel's output dim split over model
ROW = (tp.MODEL,)               # its input dim (or a stack's lead dim)
ATTENTION_SPLIT = {"Wq": COLUMN, "Wk": COLUMN, "Wv": COLUMN, "Wo": ROW}


def _heads_divide(layer, n: int):
    if layer.n_heads % n:
        raise ValueError(f"{type(layer).__name__}: n_heads {layer.n_heads} "
                         f"not divisible by the model degree {n}")


# --- context-parallel mode ------------------------------------------------
_CONTEXT_PARALLEL: list = []


class context_parallel:
    """Marks that the time axis is sharded over a ``seq`` group: `group`
    (a process group), this rank's `index` in it and the `degree`. Used
    by ContextParallelTrainer; the layers read it."""

    def __init__(self, group, index: int, degree: int):
        self.group, self.index, self.degree = group, int(index), int(degree)
        self._ring = None

    @property
    def ring(self):
        """The group as `parallel.ring.Ring`."""
        if self._ring is None:
            from deeplearning4j_tpu_torch.parallel.ring import Ring
            self._ring = Ring(self.group, self.index, self.degree)
        return self._ring

    def __enter__(self):
        _CONTEXT_PARALLEL.append(self)
        return self

    def __exit__(self, *exc):
        _CONTEXT_PARALLEL.pop()


def active_context_parallel() -> Optional[context_parallel]:
    return _CONTEXT_PARALLEL[-1] if _CONTEXT_PARALLEL else None


def _seq_offset(t_local: int) -> int:
    """Global position of this shard's first step (0 when the time axis
    is not sharded)."""
    cp = active_context_parallel()
    return 0 if cp is None else cp.index * t_local


@register_layer
@dataclasses.dataclass(frozen=True)
class LayerNormLayer(LayerConf):
    """Layer normalization over the feature axis (population variance)."""
    epsilon: float = 1e-5

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        f = input_type.features
        return {"gamma": torch.ones((f,), dtype=dtype),
                "beta": torch.zeros((f,), dtype=dtype)}, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        mean = x.mean(dim=-1, keepdim=True)
        var = x.var(dim=-1, unbiased=False, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * params["gamma"] + params["beta"], state


def _split_heads(x, n_heads):
    b, t, f = x.shape
    return x.reshape(b, t, n_heads, f // n_heads)


def _merge_heads(x):
    b, t, h, d = x.shape
    return x.reshape(b, t, h * d)


def rope(x, positions, base: float = 10000.0):
    """Rotary position embedding on (B, T, H, D): rotates the concatenated
    halves (not interleaved pairs); trig in >= f32."""
    d = x.shape[-1]
    half = d // 2
    acc_t = torch.promote_types(torch.float32, x.dtype)
    freqs = base ** (-torch.arange(0, half, dtype=acc_t, device=x.device)
                     / half)
    angles = positions[..., None].to(acc_t) * freqs     # (B?, T, half)
    while angles.dim() < x.dim():
        angles = angles[..., None, :] if angles.dim() == x.dim() - 1 \
            else angles[None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def dot_product_attention(q, k, v, *, mask=None, causal=False,
                          q_offset=0, k_offset=0, dropout=0.0,
                          generator=None):
    """Stable softmax attention on (B, T, H, D) tensors.

    mask: (B, Tk) 0/1 key-validity mask. q_offset/k_offset: global
    position offsets for causal masking across sequence shards.
    dropout: attention-probability dropout, the mask drawn from
    `generator` (none without one), applied to the normalized weights."""
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    acc_t = torch.promote_types(torch.float32, q.dtype)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc_t), k.to(acc_t)) * scale
    neg = torch.full_like(scores, NEG)
    if causal:
        qpos = q_offset + torch.arange(tq, device=q.device)
        kpos = k_offset + torch.arange(tk, device=q.device)
        scores = torch.where((qpos[:, None] >= kpos[None, :])[None, None],
                             scores, neg)
    if mask is not None:
        scores = torch.where(mask[:, None, None, :].bool(), scores, neg)
    # fully-masked query rows (all keys invalid) are zeroed at the end
    m = scores.amax(dim=-1, keepdim=True)
    weights = torch.exp(scores - m)
    denom = weights.sum(dim=-1, keepdim=True)
    weights = weights / denom.clamp_min(1e-30)
    weights = torch.where(m <= NEG / 2, torch.zeros_like(weights), weights)
    if dropout > 0.0 and generator is not None:
        keep = 1.0 - dropout
        weights = weights * (uniform(weights.shape, generator, weights.device)
                             < keep) / keep
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


@register_layer
@dataclasses.dataclass(frozen=True)
class MultiHeadAttention(LayerConf):
    """Multi-head self-attention over (B, T, F).

    attention_impl: "dense" | "blockwise" | "flash". Both "blockwise" and
    "flash" run `ops.flash_attention` unless attention dropout is on in
    training: the Hopper kernel on CUDA, its plain version on the CPU."""
    n_out: int = 0
    n_heads: int = 8
    n_in: Optional[int] = None
    causal: bool = False
    use_rope: bool = True
    attention_dropout: float = 0.0
    weight_init: str = "xavier"
    has_bias: bool = False
    attention_impl: str = "dense"
    block_size: int = 512
    TP_GROUPS = (ATTENTION_SPLIT,)

    def check_model_degree(self, n: int):
        _heads_divide(self, n)

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.shape[0]
        return InputType(Kind.RNN, (t, self.n_out))

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out {self.n_out} not divisible by "
                             f"n_heads {self.n_heads}")
        if self.use_rope and (self.n_out // self.n_heads) % 2:
            raise ValueError(
                f"rotary embeddings need an even head dim; got "
                f"{self.n_out // self.n_heads} (n_out={self.n_out}, "
                f"n_heads={self.n_heads}) — disable use_rope or resize")
        f_in = self.n_in or input_type.features
        w_init = get_initializer(self.weight_init)
        p = {name: w_init(generator, (fi, self.n_out), fi, self.n_out, dtype)
             for name, fi in (("Wq", f_in), ("Wk", f_in), ("Wv", f_in),
                              ("Wo", self.n_out))}
        if self.has_bias:
            for b in ("bq", "bk", "bv", "bo"):
                p[b] = torch.zeros((self.n_out,), dtype=dtype)
        return p, {}

    def _qkv(self, params, x, mg=None):
        """(q, k, v) heads; with a model group, this rank's heads."""
        h = self.n_heads
        if mg is not None:
            x = tp.copy_to_model(x, mg)
            h //= mg.size
        q = x @ params["Wq"]
        k = x @ params["Wk"]
        v = x @ params["Wv"]
        if self.has_bias:
            bq, bk, bv = (params[b] if mg is None
                          else tp.model_slice(params[b], mg)
                          for b in ("bq", "bk", "bv"))
            q, k, v = q + bq, k + bk, v + bv
        return _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        drop = self.attention_dropout \
            if train and generator is not None else 0.0
        x = self.maybe_dropout_input(x, train, generator)
        # column pieces of Wq/Wk/Wv: this rank's heads (tensor parallel)
        mg = tp.require(self) if params["Wq"].shape[1] != self.n_out \
            else None
        q, k, v = self._qkv(params, x, mg)
        t_loc = x.shape[1]
        if self.use_rope:
            pos = (_seq_offset(t_loc)
                   + torch.arange(t_loc, device=x.device))[None]
            q = rope(q, pos)
            k = rope(k, pos)
        flash = self.attention_impl in ("flash", "blockwise") \
            and drop == 0.0
        cp = active_context_parallel()
        if cp is not None:
            from deeplearning4j_tpu_torch.parallel import ring
            if flash:
                out = ring.ring_flash_self_attention(
                    q, k, v, ring=cp.ring, causal=self.causal, mask=mask,
                    block_q=self.block_size, block_k=self.block_size)
            else:
                out = ring.ring_self_attention(
                    q, k, v, ring=cp.ring, causal=self.causal, mask=mask,
                    dropout=drop, generator=generator)
        elif flash:
            from deeplearning4j_tpu_torch.ops.flash_attention import (
                flash_attention,
            )
            out = flash_attention(q, k, v, mask=mask, causal=self.causal,
                                  block_q=self.block_size,
                                  block_k=self.block_size)
        else:
            # the kernels draw no dropout: training with attention
            # dropout takes the plain product, as the reference takes its
            # blockwise path there
            out = dot_product_attention(q, k, v, mask=mask,
                                        causal=self.causal, dropout=drop,
                                        generator=generator)
        y = _merge_heads(out) @ params["Wo"]
        if mg is not None:          # row-parallel: the heads' partial sums
            y = tp.reduce_from_model(y, mg)
        if self.has_bias:
            y = y + params["bo"]
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, state


@register_layer
@dataclasses.dataclass(frozen=True)
class TransformerBlock(LayerConf):
    """Pre-norm transformer block: LN -> MHA -> +res -> LN -> MLP -> +res.
    mlp_ratio*n_out is the hidden width."""
    n_out: int = 0
    n_heads: int = 8
    mlp_ratio: int = 4
    causal: bool = True
    use_rope: bool = True
    activation: str = "gelu"
    attention_dropout: float = 0.0
    residual_dropout: float = 0.0
    weight_init: str = "xavier"
    attention_impl: str = "dense"
    block_size: int = 512
    TP_GROUPS = ({"attn/" + k: s for k, s in ATTENTION_SPLIT.items()},
                 {"W1": COLUMN, "W2": ROW})

    def check_model_degree(self, n: int):
        _heads_divide(self, n)

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.shape[0]
        return InputType(Kind.RNN, (t, self.n_out))

    def _sub(self):
        attn = MultiHeadAttention(
            n_out=self.n_out, n_heads=self.n_heads, causal=self.causal,
            use_rope=self.use_rope, attention_dropout=self.attention_dropout,
            weight_init=self.weight_init, attention_impl=self.attention_impl,
            block_size=self.block_size)
        return LayerNormLayer(), attn

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        f_in = input_type.features
        if f_in != self.n_out:
            raise ValueError(
                f"TransformerBlock requires input width == n_out "
                f"({f_in} != {self.n_out}); project with a DenseLayer first")
        ln, attn = self._sub()
        ln_p, _ = ln.init(generator, input_type, dtype)
        attn_p, _ = attn.init(generator, input_type, dtype)
        hidden = self.mlp_ratio * self.n_out
        w_init = get_initializer(self.weight_init)
        return {
            "ln1": ln_p,
            "attn": attn_p,
            "ln2": {"gamma": torch.ones((self.n_out,), dtype=dtype),
                    "beta": torch.zeros((self.n_out,), dtype=dtype)},
            "W1": w_init(generator, (self.n_out, hidden), self.n_out, hidden,
                         dtype),
            "b1": torch.zeros((hidden,), dtype=dtype),
            "W2": w_init(generator, (hidden, self.n_out), hidden, self.n_out,
                         dtype),
            "b2": torch.zeros((self.n_out,), dtype=dtype),
        }, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        ln, attn = self._sub()
        h, _ = ln.apply(params["ln1"], {}, x)
        a, _ = attn.apply(params["attn"], {}, h, train=train, mask=mask,
                          generator=generator)
        if train and generator is not None:
            a = dropout(a, self.residual_dropout, generator)
        x = x + a
        h, _ = ln.apply(params["ln2"], {}, x)
        act = get_activation(self.activation)
        if params["W1"].shape[1] != self.mlp_ratio * self.n_out:
            # column-parallel up, row-parallel down (tensor parallel)
            mg = tp.require(self)
            h = act(tp.copy_to_model(h, mg) @ params["W1"]
                    + tp.model_slice(params["b1"], mg))
            h = tp.reduce_from_model(h @ params["W2"], mg) + params["b2"]
        else:
            h = act(h @ params["W1"] + params["b1"])
            h = h @ params["W2"] + params["b2"]
        y = x + h
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, state


@register_layer
@dataclasses.dataclass(frozen=True)
class MoEFeedForward(LayerConf):
    """Mixture-of-experts FFN with top-k soft routing over experts stacked
    on a leading axis: every token scores every expert, weighted by the
    renormalized top-k gates."""
    n_out: int = 0
    n_experts: int = 8
    top_k: int = 2
    mlp_ratio: int = 4
    activation: str = "gelu"
    weight_init: str = "xavier"
    TP_GROUPS = ({"W1": ROW, "W2": ROW},)

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.shape[0]
        return InputType(Kind.RNN, (t, self.n_out))

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        f_in = input_type.features
        if f_in != self.n_out:
            raise ValueError("MoEFeedForward requires input width == n_out")
        hidden = self.mlp_ratio * self.n_out
        w_init = get_initializer(self.weight_init)
        e = self.n_experts

        def ew(shape, fi, fo):
            return torch.stack([w_init(generator, shape, fi, fo, dtype)
                                for _ in range(e)])

        return {
            "Wg": w_init(generator, (f_in, e), f_in, e, dtype),
            "W1": ew((f_in, hidden), f_in, hidden),
            "b1": torch.zeros((e, hidden), dtype=dtype),
            "W2": ew((hidden, self.n_out), hidden, self.n_out),
            "b2": torch.zeros((e, self.n_out), dtype=dtype),
        }, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        gates = torch.softmax(x @ params["Wg"], dim=-1)       # (B, T, E)
        if self.top_k < self.n_experts:
            thresh = torch.topk(gates, self.top_k, dim=-1).values[..., -1:]
            gates = torch.where(gates >= thresh, gates,
                                torch.zeros_like(gates))
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        act = get_activation(self.activation)
        b1, b2 = params["b1"], params["b2"]
        mg = tp.require(self) if params["W1"].shape[0] != self.n_experts \
            else None
        if mg is not None:
            # expert parallel: this rank's experts, their gates and biases
            x = tp.copy_to_model(x, mg)
            gates, b1, b2 = (tp.model_slice(t, mg, d)
                             for t, d in ((gates, -1), (b1, 0), (b2, 0)))
        h = act(torch.einsum("btf,efh->bteh", x, params["W1"]) + b1)
        y = torch.einsum("bteh,eho->bteo", h, params["W2"]) + b2
        out = torch.einsum("bteo,bte->bto", y, gates)
        if mg is not None:
            out = tp.reduce_from_model(out, mg)
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out, state


@register_layer
@dataclasses.dataclass(frozen=True)
class PositionalEmbeddingLayer(LayerConf):
    """Learned absolute position embeddings added to (B, T, F)."""
    max_length: int = 2048

    def output_type(self, input_type: InputType) -> InputType:
        return input_type

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        f = input_type.features
        p = torch.randn((self.max_length, f), generator=generator) * 0.02
        return {"P": p.to(dtype)}, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        t = x.shape[1]
        cp = active_context_parallel()
        if cp is None:
            if t > self.max_length:
                raise ValueError(f"sequence length {t} exceeds max_length "
                                 f"{self.max_length}")
            return x + params["P"][:t][None], state
        # a context-parallel shard: this shard's rows; the global length
        # must fit (a slice past the table would be silently short)
        if t * cp.degree > self.max_length:
            raise ValueError(f"global sequence length {t * cp.degree} "
                             f"exceeds max_length {self.max_length}")
        start = _seq_offset(t)
        return x + params["P"][start:start + t][None], state


@register_layer
@dataclasses.dataclass(frozen=True)
class EmbeddingSequenceLayer(LayerConf):
    """Token-id sequence -> embedding sequence: (B, T) or (B, T, 1) ids,
    float or int, to (B, T, n_out). Float ids are truncated to int."""
    n_out: int = 0
    n_in: Optional[int] = None      # vocabulary size (required)
    weight_init: str = "normal"
    #: vocab-parallel rows, or column pieces (`ShardingRules.megatron()`)
    TP_GROUPS = ({"W": ROW}, {"W": COLUMN})

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.shape[0]
        return InputType(Kind.RNN, (t, self.n_out))

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        if not self.n_in:
            raise ValueError("EmbeddingSequenceLayer requires n_in "
                             "(vocabulary size)")
        table = torch.randn((self.n_in, self.n_out), generator=generator) * 0.02
        return {"W": table.to(dtype)}, {}

    def id_range(self, params):
        """(vocabulary size, the ValueError message of an id outside)."""
        return self.n_in, f"token ids must lie in [0, {self.n_in})"

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        if x.dim() == 3:
            x = x[..., 0]
        idx = x.to(torch.int64)
        # an id out of range would trip a device-side assert on CUDA,
        # which poisons the whole context: refuse it as bad input instead
        check_ids(self, idx, *self.id_range(params))
        w = params["W"]
        if w.shape[0] != self.n_in:
            # vocab parallel: this rank's rows; other ids give zeros
            mg = tp.require(self)
            local = idx - mg.index * w.shape[0]
            inside = (local >= 0) & (local < w.shape[0])
            y = w[local.clamp(0, w.shape[0] - 1)] \
                * inside[..., None].to(w.dtype)
            y = tp.reduce_from_model(y, mg)
        elif w.shape[1] != self.n_out:
            y = tp.gather_from_model(w[idx], tp.require(self))
        else:
            y = w[idx]
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, state
