"""Post-training quantization for decode servables.

Counterpart of the JAX package's `serving/quantize.py`. Token-by-token
decode re-reads every weight once per generated token, so at the batch
sizes the decode slots reach the step is bound by the bytes it moves, and
weight bytes dominate:

- **int8** — symmetric per-output-channel weight-only PTQ. Each weight
  matrix W is stored as ``int8 q`` plus a float32 per-channel ``scale``
  (``W ≈ q * scale``) over the contraction axis. Activations stay float;
  `qdot` converts q to the activations' dtype before the product.
- **bf16** — a straight cast of the params (and of the KV pools, which
  the engine keys off the variant): half the bytes.

Quality is measured, not assumed: `quality_delta()` scores a base and a
variant engine on the same tokens (next-token perplexity and mean
absolute logit error).

`QTensor` is a plain holder of ``q`` and ``scale``; `qdot`/`qtake` are the
two consumption sites (matmul and embedding lookup) the decode engine
routes every quantizable weight through.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

#: registry-variant names accepted as a ``@<mode>`` source suffix
QUANT_MODES = ("int8", "bf16")


class QTensor:
    """Symmetric per-channel int8 weight: ``dequant = q * scale``.

    q: int8, the weight's shape. scale: float32, q's shape with the
    contraction (second-to-last) axis reduced to 1 — one scale per output
    channel (and per expert for stacked 3D weights)."""

    __slots__ = ("q", "scale")

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    @property
    def shape(self):
        return self.q.shape

    @property
    def dtype(self):            # reported dtype = storage dtype
        return self.q.dtype

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        return self.q.to(dtype) * self.scale.to(dtype)

    def __repr__(self):
        return f"QTensor(int8 {tuple(self.q.shape)})"


def quantize_leaf(w: torch.Tensor) -> QTensor:
    """W (float, ndim >= 2) -> per-output-channel symmetric int8. Rounds
    half to even, as the reference's `jnp.round`."""
    if w.dim() < 2:
        raise ValueError(f"quantize_leaf needs a matrix, got {tuple(w.shape)}")
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale)


def qdot(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w where w is a float tensor or a QTensor (weight-only int8: q
    converted to x's dtype, the product, then the per-channel scale)."""
    if isinstance(w, QTensor):
        y = x @ w.q.to(x.dtype)
        return y * w.scale.to(x.dtype)
    return x @ w


def qtake(w, idx: torch.Tensor) -> torch.Tensor:
    """Embedding-row gather from a float tensor or QTensor table. The ids
    must already be validated: on CUDA an out-of-range id trips a
    device-side assert."""
    if isinstance(w, QTensor):
        rows = w.q[idx].to(torch.float32)
        return rows * w.scale.to(torch.float32)
    return w[idx]


def cast_tree_bf16(params):
    """bf16 servable variant: every float leaf -> bfloat16 (the engine
    runs activations and the KV pools in bf16 too)."""
    if isinstance(params, dict):
        return {k: cast_tree_bf16(v) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.to(torch.bfloat16)
    return params


def is_spec_variant(variant) -> bool:
    """True for the speculative-decoding variant suffix: bare ``spec`` or
    ``spec:opt=val,...``."""
    return isinstance(variant, str) and (
        variant == "spec" or variant.startswith("spec:"))


def parse_variant(source: str):
    """Split a servable source's ``@<variant>`` suffix: ``@int8`` /
    ``@bf16`` (quantized weights) or ``@spec[:...]`` (speculative
    decoding).

    ``zoo:TransformerLM?n_layers=2@int8`` -> (``zoo:...?n_layers=2``,
    ``"int8"``); ``ckpt@spec:draft=int8,k=4`` -> (``ckpt``,
    ``"spec:draft=int8,k=4"``); plain sources come back with variant
    None."""
    if isinstance(source, str) and "@" in source:
        # @spec splits at its FIRST occurrence: the options may name a
        # draft source carrying its own @int8/@bf16 suffix
        i = source.find("@spec")
        if i > 0 and is_spec_variant(source[i + 1:]):
            return source[:i], source[i + 1:]
        base, _, suffix = source.rpartition("@")
        if suffix in QUANT_MODES:
            return base, suffix
    return source, None


# --------------------------------------------------------------- quality
def _log_softmax(z: np.ndarray) -> np.ndarray:
    m = z.max(axis=-1, keepdims=True)
    s = z - m
    return s - np.log(np.exp(s).sum(axis=-1, keepdims=True))


def perplexity_from_logits(logits: np.ndarray, tokens: np.ndarray) -> float:
    """Next-token perplexity of (B, T, V) logits against (B, T) ids."""
    lp = _log_softmax(np.asarray(logits, np.float64))[:, :-1]
    tgt = np.asarray(tokens)[:, 1:].astype(int)
    nll = -np.take_along_axis(lp, tgt[..., None], axis=-1).mean()
    return float(np.exp(nll))


def quality_delta(base_engine, variant_engine, tokens) -> dict:
    """Measured accuracy cost of a quantized variant against its base
    engine on one token batch: perplexity both ways, relative delta, and
    mean absolute logit error."""
    tokens = np.asarray(tokens, np.int32)
    base_logits = np.asarray(base_engine.logits_full(tokens), np.float32)
    var_logits = np.asarray(variant_engine.logits_full(tokens), np.float32)
    ppl_base = perplexity_from_logits(base_logits, tokens)
    ppl_var = perplexity_from_logits(var_logits, tokens)
    return {
        "ppl_base": round(ppl_base, 6),
        "ppl_variant": round(ppl_var, 6),
        "ppl_delta_pct": round(100.0 * (ppl_var - ppl_base)
                               / max(ppl_base, 1e-12), 4),
        "logit_mae": round(float(np.mean(np.abs(var_logits - base_logits))),
                           6),
    }


def quantize_params(params: dict, mode: Optional[str]):
    """Apply a variant mode to an extracted LM param tree.

    int8 quantizes exactly the leaves the decode engine consumes through
    qdot/qtake (attention projections, MLP matrices, the LM head, the
    embedding table); biases, layer norms and per-token layers (MoE) stay
    float, since `layer.apply` takes plain tensors. bf16 casts the whole
    tree. None returns the tree untouched. The input tree is not
    modified."""
    if mode is None:
        return params
    if mode == "bf16":
        return cast_tree_bf16(params)
    if mode != "int8":
        raise ValueError(f"unknown quantize mode {mode!r}; "
                         f"known: {QUANT_MODES}")

    def copy(d):
        return {k: copy(v) if isinstance(v, dict) else v
                for k, v in d.items()}

    def q2d(d, keys):
        for k in keys:
            if k in d:
                d[k] = quantize_leaf(d[k])

    out = copy(params)
    for sub in out.values():
        if not isinstance(sub, dict):
            continue
        if "attn" in sub:                         # TransformerBlock
            q2d(sub["attn"], ("Wq", "Wk", "Wv", "Wo"))
            q2d(sub, ("W1", "W2"))
        elif set(sub) == {"W"} or set(sub) == {"W", "b"}:
            # embedding table or LM head projection
            q2d(sub, ("W",))
    return out
