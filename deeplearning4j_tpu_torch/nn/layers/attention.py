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
and uses their plain versions on a CPU tensor. The context-parallel (ring)
branches come with the parallel slice.

Training draws its dropout masks from an explicit `torch.Generator` on the
activations' device (the reference splits a JAX key per layer; the two
streams differ, so parity tests run dropout-free). Input dropout
(`dropout`) applies where the reference applies it: `MultiHeadAttention`
and the output head; `TransformerBlock` adds its residual dropout.
Attention-probability dropout in training comes with a later slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.base import (
    InputType, Kind, LayerConf, dropout, register_layer,
)
from deeplearning4j_tpu_torch.nn.initializers import get_initializer

NEG = -1e30


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
                          q_offset=0, k_offset=0):
    """Stable softmax attention on (B, T, H, D) tensors.

    mask: (B, Tk) 0/1 key-validity mask. q_offset/k_offset: global
    position offsets for causal masking across sequence shards."""
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
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)


@register_layer
@dataclasses.dataclass(frozen=True)
class MultiHeadAttention(LayerConf):
    """Multi-head self-attention over (B, T, F).

    attention_impl: "dense" | "blockwise" | "flash". Both "blockwise" and
    "flash" run `ops.flash_attention` when there is no dropout: the
    Hopper kernel on CUDA, its plain version on the CPU."""
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

    def _qkv(self, params, x):
        q = x @ params["Wq"]
        k = x @ params["Wk"]
        v = x @ params["Wv"]
        if self.has_bias:
            q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
        h = self.n_heads
        return _split_heads(q, h), _split_heads(k, h), _split_heads(v, h)

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        if train and self.attention_dropout > 0:
            raise NotImplementedError(
                "attention-probability dropout in training comes with a "
                "later slice of the port (the reference trains it through "
                "its blockwise path, not the flash kernels)")
        x = self.maybe_dropout_input(x, train, generator)
        q, k, v = self._qkv(params, x)
        if self.use_rope:
            pos = torch.arange(x.shape[1], device=x.device)[None]
            q = rope(q, pos)
            k = rope(k, pos)
        if self.attention_impl in ("flash", "blockwise"):
            from deeplearning4j_tpu_torch.ops.flash_attention import (
                flash_attention,
            )
            out = flash_attention(q, k, v, mask=mask, causal=self.causal,
                                  block_q=self.block_size,
                                  block_k=self.block_size)
        else:
            out = dot_product_attention(q, k, v, mask=mask,
                                        causal=self.causal)
        y = _merge_heads(out) @ params["Wo"]
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
        h = get_activation(self.activation)(h @ params["W1"] + params["b1"])
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
        h = act(torch.einsum("btf,efh->bteh", x, params["W1"]) + params["b1"])
        y = torch.einsum("bteh,eho->bteo", h, params["W2"]) + params["b2"]
        out = torch.einsum("bteo,bte->bto", y, gates)
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
        if t > self.max_length:
            raise ValueError(f"sequence length {t} exceeds max_length "
                             f"{self.max_length}")
        return x + params["P"][:t][None], state


@register_layer
@dataclasses.dataclass(frozen=True)
class EmbeddingSequenceLayer(LayerConf):
    """Token-id sequence -> embedding sequence: (B, T) or (B, T, 1) ids,
    float or int, to (B, T, n_out). Float ids are truncated to int."""
    n_out: int = 0
    n_in: Optional[int] = None      # vocabulary size (required)
    weight_init: str = "normal"

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.shape[0]
        return InputType(Kind.RNN, (t, self.n_out))

    def init(self, generator, input_type: InputType, dtype=torch.float32):
        if not self.n_in:
            raise ValueError("EmbeddingSequenceLayer requires n_in "
                             "(vocabulary size)")
        table = torch.randn((self.n_in, self.n_out), generator=generator) * 0.02
        return {"W": table.to(dtype)}, {}

    def apply(self, params, state, x, *, train=False, mask=None,
              generator=None):
        if x.dim() == 3:
            x = x[..., 0]
        idx = x.to(torch.int64)
        # an id out of range would trip a device-side assert on CUDA,
        # which poisons the whole context: refuse it as bad input instead
        if bool(((idx < 0) | (idx >= self.n_in)).any()):
            raise ValueError(f"token ids must lie in [0, {self.n_in})")
        y = params["W"][idx]
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, state
