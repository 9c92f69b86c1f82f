"""Token-level continuous batching — the LM decode runtime.

Counterpart of the JAX package's `serving/decode.py`: iteration-level
scheduling (Orca/vLLM) over a paged KV cache (`serving/kvcache.py`).

- **Fixed shapes, warmed at load.** Decode runs over ``slots`` fixed
  batch positions with an active mask; prefill runs per bucket of a
  page-aligned ladder (`kvcache.default_prefill_buckets`), and so does the
  chunk program a cache hit or a long prompt goes through. `warm()` runs
  every program once at load time (kernel module loads, allocator growth)
  and `request_path_first_runs` counts any program first run by a live
  request instead (0 is the contract). The programs run eager; capturing
  them in CUDA graphs is the counterpart of the reference's AOT-compiled
  programs and comes with a later slice.
- **Continuous batching.** `DecodeScheduler` admits queued requests into
  free slots *between token steps*: a late join's prefill lands while
  other sequences keep decoding, in budgeted chunks so one long prompt
  cannot stall every stream.
- **Sampling on the device.** Greedy / temperature / top-k run on the
  logits where they were computed (Gumbel-max, one argmax), so the host
  sees one integer per slot per step: one device-to-host copy, the
  step's only synchronisation.

Every attention here is the dense `dot_product_attention` after a page
gather, as in the reference (`decode.py:512,550,585` there): the decode
path launches no hand-written kernel.

Not ported yet: speculative decoding (the draft engine, verify and
propose programs, ``@spec``), the host spill tier and KV page
export/import, rolling swap and rollback, and the metrics, flight and
goodput hooks.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.layers.attention import (
    EmbeddingSequenceLayer, LayerNormLayer, MoEFeedForward,
    MultiHeadAttention, PositionalEmbeddingLayer, TransformerBlock,
    _merge_heads, _split_heads, dot_product_attention, rope,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.serving import kvcache
from deeplearning4j_tpu_torch.serving.batcher import (
    DeadlineExceededError, ServerDrainingError, ServerOverloadedError,
)
from deeplearning4j_tpu_torch.serving.quantize import (
    QUANT_MODES, is_spec_variant, qdot, qtake, quantize_params,
)
from deeplearning4j_tpu_torch.serving.registry import ModelLoadError

log = logging.getLogger("deeplearning4j_tpu_torch")

_LN = LayerNormLayer()          # the block-internal LN (default epsilon)

#: static ceiling for the top-k gate (per-request k is clipped)
TOP_K_MAX = 64


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Decode-runtime sizing, fixed at servable load time."""
    slots: int = 4                       # fixed decode batch positions
    page_size: int = 16                  # tokens per KV page
    max_context: Optional[int] = None    # default: the model's seq_length
    pool_pages: Optional[int] = None     # default: no oversubscription
    prefill_buckets: Optional[Sequence[int]] = None
    quantize: Optional[str] = None       # None | "int8" | "bf16"
    queue_limit: int = 64                # pending-join bound (full -> 429)
    max_new_tokens_cap: int = 1024       # server-side generation ceiling
    seed: int = 0                        # sampling stream
    #: share KV pages across requests with a common prompt prefix
    #: (radix-indexed, copy-on-write; released prefixes retained LRU)
    prefix_cache: bool = True
    #: per-scheduler-tick prefill-token budget: long uncached suffixes
    #: split into chunks of at most this many tokens, run BETWEEN decode
    #: steps. None = auto (4 pages); 0 = off (whole suffix in one call)
    prefill_chunk_tokens: Optional[int] = None


def apply_variant(cfg: DecodeConfig, variant: Optional[str]) -> DecodeConfig:
    """Apply a parsed ``@<variant>`` source suffix: ``int8``/``bf16``
    select quantized weights; ``@spec`` is not ported yet."""
    if variant is None:
        return cfg
    if variant in QUANT_MODES:
        return dataclasses.replace(cfg, quantize=variant)
    if is_spec_variant(variant):
        raise ModelLoadError(
            f"@{variant}: speculative decoding is not yet ported to the "
            "PyTorch package")
    raise ValueError(f"unknown servable variant {variant!r}; known: "
                     f"{QUANT_MODES}")


class GenerateRequest:
    """One in-flight generation: token events stream out through a queue
    (("token", id) / ("done", info) / ("error", exc))."""

    def __init__(self, prompt, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None,
                 deadline: Optional[float] = None):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_id = None if eos_id is None else int(eos_id)
        #: absolute time.monotonic() budget for the WHOLE generation
        self.deadline = deadline
        self.events: "queue.Queue" = queue.Queue()
        self.enqueued = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.n_emitted = 0
        self.version: Optional[int] = None
        self.finish_reason: Optional[str] = None
        #: prompt positions served from the shared prefix cache (set at
        #: admission) and prefill calls it took to cover the uncached
        #: suffix (set when prefill completes)
        self.cached_tokens = 0
        self.prefill_chunks = 0
        self.cancelled = threading.Event()
        self.done = threading.Event()

    # ------------------------------------------------------------- events
    def emit(self, token: int):
        self.n_emitted += 1
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.events.put(("token", int(token)))

    def finish(self, reason: str):
        if self.done.is_set():
            return
        self.finish_reason = reason
        self.done.set()
        # the spec_* fields keep the reference's wire format; speculative
        # decoding is not ported, so they are 0
        self.events.put(("done", {
            "finish_reason": reason,
            "tokens": self.n_emitted,
            "version": self.version,
            "cached_tokens": self.cached_tokens,
            "prefill_chunks": self.prefill_chunks,
            "spec_proposed": 0, "spec_accepted": 0, "spec_rounds": 0,
        }))

    def fail(self, exc: Exception):
        if self.done.is_set():
            return
        self.finish_reason = "error"
        self.done.set()
        self.events.put(("error", exc))

    def cancel(self):
        """Client went away: the scheduler frees the slot at the next
        token boundary."""
        self.cancelled.set()


# ==========================================================================
# The engine: prefill / decode / scoring programs + cache state
# ==========================================================================
class DecodeEngine:
    """Paged-KV decode runtime for one model version, on the model's
    device.

    Drives a MultiLayerNetwork whose stack is an LM the runtime
    understands (EmbeddingSequenceLayer, TransformerBlock /
    MoEFeedForward / LayerNormLayer / PositionalEmbeddingLayer bodies,
    RnnOutputLayer head — the models/transformer.py family), with its
    params optionally quantized (`quantize.py`). Every device call must
    come from one thread at a time (the scheduler's)."""

    def __init__(self, model, cfg: DecodeConfig, name: str = "lm"):
        self.cfg = cfg
        self.name = name
        conf = model.conf
        it = getattr(conf, "input_type", None)
        if it is None or not model.layers:
            raise ModelLoadError(
                f"decode[{name}]: model has no recurrent input_type; not "
                "an LM this runtime can drive")
        self.max_context = int(cfg.max_context or it.shape[0])
        if cfg.page_size < 1 or self.max_context % cfg.page_size:
            raise ModelLoadError(
                f"decode[{name}]: max_context {self.max_context} must be "
                f"a positive multiple of page_size {cfg.page_size}")
        # ---------------------------------------------- layer extraction
        self._plan: List[Tuple[str, object, str]] = []
        self._block_index: Dict[str, int] = {}
        self.vocab: Optional[int] = None
        self.n_heads = self.head_dim = None
        for i, layer in enumerate(model.layers):
            key = str(i)
            last = i == len(model.layers) - 1
            if isinstance(layer, EmbeddingSequenceLayer):
                self._plan.append(("embed", layer, key))
                self.vocab = int(layer.n_in)
            elif isinstance(layer, PositionalEmbeddingLayer):
                if layer.max_length < self.max_context:
                    raise ModelLoadError(
                        f"decode[{name}]: positional table "
                        f"({layer.max_length}) shorter than max_context "
                        f"({self.max_context})")
                self._plan.append(("posembed", layer, key))
            elif isinstance(layer, TransformerBlock):
                if not layer.causal:
                    raise ModelLoadError(
                        f"decode[{name}]: layer {i} is a non-causal "
                        "TransformerBlock; autoregressive decode needs "
                        "causal attention")
                h = layer.n_heads
                d = layer.n_out // layer.n_heads
                if self.n_heads not in (None, h) or \
                        self.head_dim not in (None, d):
                    raise ModelLoadError(
                        f"decode[{name}]: non-uniform head geometry "
                        "across blocks is not supported")
                self.n_heads, self.head_dim = h, d
                self._block_index[key] = len(self._block_index)
                self._plan.append(("block", layer, key))
            elif isinstance(layer, (LayerNormLayer, MoEFeedForward)):
                self._plan.append(("pertoken", layer, key))
            elif isinstance(layer, RnnOutputLayer) and last:
                self._plan.append(("head", layer, key))
                if self.vocab is None:
                    self.vocab = int(layer.n_out)
            elif isinstance(layer, MultiHeadAttention):
                raise ModelLoadError(
                    f"decode[{name}]: bare MultiHeadAttention at layer "
                    f"{i}; wrap it in a TransformerBlock for decode")
            else:
                raise ModelLoadError(
                    f"decode[{name}]: layer {i} "
                    f"({type(layer).__name__}) has no incremental decode "
                    "path")
        if not self._block_index or self.vocab is None:
            raise ModelLoadError(
                f"decode[{name}]: need at least one TransformerBlock and "
                "a vocabulary head")
        self.n_layers = len(self._block_index)
        # ------------------------------------------------------- buffers
        self.device = torch.device(model.device)
        self._params = quantize_params(model.params, cfg.quantize)
        self._dtype = torch.bfloat16 if cfg.quantize == "bf16" \
            else torch.float32
        self.cache = kvcache.KVCacheState(
            cfg.slots, cfg.page_size, self.max_context,
            pool_pages=cfg.pool_pages, name=name,
            prefix_cache=cfg.prefix_cache)
        # per-tick prefill-token budget (page-aligned, rounded up): None
        # = auto (4 pages), <= 0 = chunking off
        if cfg.prefill_chunk_tokens is None:
            self.prefill_chunk_tokens = min(4 * cfg.page_size,
                                            self.max_context)
        elif cfg.prefill_chunk_tokens <= 0:
            self.prefill_chunk_tokens = 0
        else:
            self.prefill_chunk_tokens = min(
                self.max_context,
                ((int(cfg.prefill_chunk_tokens) + cfg.page_size - 1)
                 // cfg.page_size) * cfg.page_size)
        self.prefill_buckets = tuple(sorted(set(
            int(b) for b in (cfg.prefill_buckets
                             or kvcache.default_prefill_buckets(
                                 cfg.page_size, self.max_context)))))
        for b in self.prefill_buckets:
            if b < 1 or b % cfg.page_size or b > self.max_context:
                raise ModelLoadError(
                    f"decode[{name}]: prefill bucket {b} must be a "
                    f"page-aligned size <= max_context")
        pool_shape = (self.n_layers, self.cache.pool_pages,
                      cfg.page_size, self.n_heads, self.head_dim)
        self._kpool = torch.zeros(pool_shape, dtype=self._dtype,
                                  device=self.device)
        self._vpool = torch.zeros(pool_shape, dtype=self._dtype,
                                  device=self.device)
        # per-slot host state
        self._temps = np.zeros((cfg.slots,), np.float32)
        self._topks = np.zeros((cfg.slots,), np.int32)
        self._last_tokens = np.zeros((cfg.slots,), np.int32)
        self._counter = 0
        self._programs: set = set()
        #: programs whose first run was a live request's, not warm()'s
        self.request_path_first_runs = 0
        self.warmup_runs = 0
        self.steps = 0

    # ------------------------------------------------------------ transfers
    def _to_device(self, ints: Sequence[np.ndarray],
                   floats: Sequence[np.ndarray] = ()):
        """Host operands -> the device in ONE copy: the int arrays and the
        float32 arrays (their values carried exactly as float64 bits) are
        packed into one int64 buffer. Returns the int tensors (int64) and
        the float tensors (float32), in order."""
        ints = [np.asarray(a, np.int64).reshape(-1) for a in ints]
        floats = [np.asarray(a, np.float64).reshape(-1) for a in floats]
        buf = np.concatenate(ints + [f.view(np.int64) for f in floats])
        # pageable memory: the copy is staged before .to() returns, and
        # non_blocking keeps it from synchronizing the stream
        dev = torch.from_numpy(buf).to(self.device, non_blocking=True)
        out, i = [], 0
        for a in ints:
            out.append(dev[i:i + a.size])
            i += a.size
        for f in floats:
            out.append(dev[i:i + f.size].view(torch.float64).float())
            i += f.size
        return out

    def _check_ids(self, tokens: np.ndarray):
        """On CUDA an out-of-range id trips a device-side assert that
        poisons the context: refuse it on the host first."""
        if tokens.size and (tokens.min() < 0 or tokens.max() >= self.vocab):
            raise ValueError(f"token ids must lie in [0, {self.vocab})")

    # --------------------------------------------------------- the forward
    def _forward_tokens(self, params, tokens, mask):
        """(B, T) ids -> ((B, T, V) pre-softmax logits, per-block roped
        (K, V) lists), through the same layer math as net.output()."""
        x = None
        kvs = []
        t = tokens.shape[1]
        pos = torch.arange(t, device=tokens.device)[None]
        for kind, layer, key in self._plan:
            p = params[key]
            if kind == "embed":
                x = qtake(p["W"], tokens)
                if mask is not None:
                    x = x * mask[..., None].to(x.dtype)
            elif kind == "posembed":
                x = x + p["P"][:t][None]
            elif kind == "pertoken":
                x, _ = layer.apply(p, {}, x, train=False, mask=mask)
            elif kind == "block":
                x, k, v = self._block_full(layer, p, x, mask, pos)
                kvs.append((k, v))
            else:                                           # head
                z = qdot(x, p["W"])
                if "b" in p:
                    z = z + p["b"]
                x = z
        return x, kvs

    @staticmethod
    def _qkv(conf, p, h):
        a = p["attn"]
        q = _split_heads(qdot(h, a["Wq"]), conf.n_heads)
        k = _split_heads(qdot(h, a["Wk"]), conf.n_heads)
        v = _split_heads(qdot(h, a["Wv"]), conf.n_heads)
        return q, k, v

    @staticmethod
    def _mlp(conf, p, x):
        """The block's second half: x + MLP(LN2(x))."""
        h, _ = _LN.apply(p["ln2"], {}, x)
        h = get_activation(conf.activation)(qdot(h, p["W1"]) + p["b1"])
        return x + (qdot(h, p["W2"]) + p["b2"])

    def _block_full(self, conf, p, x, mask, pos):
        """TransformerBlock full-sequence forward, returning the roped
        K / raw V the cache stores."""
        h, _ = _LN.apply(p["ln1"], {}, x)
        q, k, v = self._qkv(conf, p, h)
        if conf.use_rope:
            q = rope(q, pos)
            k = rope(k, pos)
        out = dot_product_attention(q, k, v, mask=mask, causal=conf.causal)
        y = qdot(_merge_heads(out), p["attn"]["Wo"])
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        y = self._mlp(conf, p, x + y)
        if mask is not None:
            y = y * mask[..., None].to(y.dtype)
        return y, k, v

    def _block_decode(self, conf, p, li, x, page_table, phys, off, valid,
                      pos):
        """One-token incremental block forward against the paged cache:
        append this token's K/V at (phys, off), gather every slot's
        sequence, attend the positions `valid` marks."""
        h, _ = _LN.apply(p["ln1"], {}, x)
        q, k, v = self._qkv(conf, p, h)
        if conf.use_rope:
            q = rope(q, pos)
            k = rope(k, pos)
        kvcache.append_token_kv(self._kpool, self._vpool, li, k[:, 0],
                                v[:, 0], phys, off)
        keys, vals = kvcache.gather_kv(self._kpool, self._vpool, li,
                                       page_table, self.max_context)
        out = dot_product_attention(q, keys, vals, mask=valid, causal=False)
        y = qdot(_merge_heads(out), p["attn"]["Wo"])
        return self._mlp(conf, p, x + y)

    def _block_chunk(self, conf, p, li, x, page_row, pos, phys, start, mask):
        """Incremental block forward for a prefill CHUNK: Tb suffix tokens
        of ONE slot at absolute positions `pos` (= start + arange),
        attending the paged cache — cached prefix pages AND the chunk's
        own rows, written first. Chunks may start mid-page (the COW
        recompute does), so rows scatter by absolute (page, offset),
        padding rows steered to the dump page."""
        h, _ = _LN.apply(p["ln1"], {}, x)
        q, k, v = self._qkv(conf, p, h)
        if conf.use_rope:
            q = rope(q, pos[None])
            k = rope(k, pos[None])
        kvcache.write_chunk_kv(self._kpool, self._vpool, li, k[0], v[0],
                               phys, pos % self.cfg.page_size)
        keys, vals = kvcache.gather_kv(self._kpool, self._vpool, li,
                                       page_row[None], self.max_context)
        # validity is pure causality: every cached position < a query's
        # absolute position was written (by a donor prefill, an earlier
        # chunk, or this chunk's own scatter above); positions >= end sit
        # past every valid query and the causal mask excludes them
        out = dot_product_attention(q, keys, vals, mask=None, causal=True,
                                    q_offset=start)
        y = qdot(_merge_heads(out), p["attn"]["Wo"])
        y = self._mlp(conf, p, x + y * mask[..., None].to(y.dtype))
        return y * mask[..., None].to(y.dtype)

    # ----------------------------------------------------------- sampling
    def _gumbel(self, shape, counter: int) -> torch.Tensor:
        """Gumbel(0, 1) noise, a pure function of (cfg.seed, counter): a
        generator on the pools' device seeded from both, and
        -log(Exponential(1)) with the draw kept above 0."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(((int(self.cfg.seed) & 0xFFFFFFFF) << 32)
                        | (int(counter) & 0xFFFFFFFF))
        e = torch.empty(shape, dtype=torch.float32, device=self.device)
        e.exponential_(generator=gen)
        return -torch.log(e.clamp_min_(torch.finfo(torch.float32).tiny))

    def _sample(self, logits, temps, topks, counter: int):
        """Greedy / temperature / top-k per row (Gumbel-max: one argmax
        whatever the temperature). temps/topks None means every row is
        greedy, and the noise is not drawn."""
        lg = logits.to(torch.float32)
        greedy = torch.argmax(lg, dim=-1)
        if temps is None:
            return greedy
        v = lg.shape[-1]
        kmax = min(TOP_K_MAX, v)
        top_vals = torch.topk(lg, kmax, dim=-1).values
        kth = top_vals.gather(-1, (topks.clamp(1, kmax) - 1)[:, None])
        keep = (topks <= 0)[:, None] | (lg >= kth)
        filt = lg.masked_fill(~keep, float("-inf"))
        g = self._gumbel(lg.shape, counter)
        hot = temps > 0
        safe_t = torch.where(hot, temps, torch.ones_like(temps))[:, None]
        sampled = torch.argmax(filt / safe_t + g, dim=-1)
        return torch.where(hot, sampled, greedy)

    # ------------------------------------------------------------ programs
    def _prefill_fn(self, tokens: np.ndarray, length: int,
                    page_row: np.ndarray, temp: float, topk: int,
                    counter: int):
        """tokens (Tb,) bucket-padded; page_row (pages_per_slot,).
        Returns (first sampled token (), last-position logits (V,)), on
        the device."""
        tb = tokens.shape[0]
        sampling = temp > 0
        ops = self._to_device([tokens, page_row, [topk]],
                              [[temp]] if sampling else [])
        toks, row = ops[0][None], ops[1]
        mask = (torch.arange(tb, device=self.device)[None]
                < length).to(torch.float32)
        logits, kvs = self._forward_tokens(self._params, toks, mask)
        for li, (k, v) in enumerate(kvs):
            kvcache.write_prompt_kv(self._kpool, self._vpool, li, k[0], v[0],
                                    row, self.cfg.page_size)
        last = logits[0, length - 1]
        tok = self._sample(last[None], ops[3] if sampling else None, ops[2],
                           counter)[0]
        return tok, last

    def _chunk_fn(self, tokens: np.ndarray, start: int, end: int,
                  page_row: np.ndarray, temp: float, topk: int,
                  counter: int):
        """Suffix-chunk prefill: tokens (Tb,) are prompt positions
        [start, end) of one slot (bucket-padded past end - start), with
        everything before `start` already cached in the slot's pages.
        Returns (sampled token (), last-valid-position logits (V,)) — the
        sample is only meaningful on the final chunk."""
        tb = tokens.shape[0]
        sampling = temp > 0
        ops = self._to_device([tokens, page_row, [topk]],
                              [[temp]] if sampling else [])
        toks, row = ops[0][None], ops[1]
        pos = start + torch.arange(tb, device=self.device)
        valid = pos < end
        mask = valid.to(torch.float32)[None]            # (1, Tb)
        page_idx = (pos // self.cfg.page_size).clamp(0, row.shape[0] - 1)
        phys = torch.where(valid, row[page_idx],
                           torch.zeros_like(page_idx))  # DUMP_PAGE
        x = None
        for kind, layer, key in self._plan:
            p = self._params[key]
            if kind == "embed":
                x = qtake(p["W"], toks)
                x = x * mask[..., None].to(x.dtype)
            elif kind == "posembed":
                idx = pos.clamp(0, layer.max_length - 1)
                x = x + p["P"][idx][None]
            elif kind == "pertoken":
                x, _ = layer.apply(p, {}, x, train=False, mask=mask)
            elif kind == "block":
                x = self._block_chunk(layer, p, self._block_index[key], x,
                                      row, pos, phys, start, mask)
            else:                                       # head
                z = qdot(x, p["W"])
                if "b" in p:
                    z = z + p["b"]
                x = z
        last = x[0, min(max(end - 1 - start, 0), tb - 1)]
        tok = self._sample(last[None], ops[3] if sampling else None, ops[2],
                           counter)[0]
        return tok, last

    def _step_body(self, page_table, seq_lens, tokens, active):
        """The one-token decode forward over every slot (inactive slots
        compute masked garbage into the dump page). Returns logits
        (S, V)."""
        ps = self.cfg.page_size
        slots = torch.arange(seq_lens.shape[0], device=self.device)
        # a slot at the context cap is inactive; clamp keeps its (unused)
        # page lookup in range
        page_idx = (seq_lens // ps).clamp_max(page_table.shape[1] - 1)
        phys = torch.where(active, page_table[slots, page_idx],
                           torch.zeros_like(page_idx))  # DUMP_PAGE
        off = seq_lens % ps
        # validity: cached positions 0..seq_len INCLUSIVE (the row this
        # step appends is position seq_len)
        valid = (torch.arange(self.max_context, device=self.device)[None, :]
                 <= seq_lens[:, None]).to(torch.float32)
        pos = seq_lens[:, None]
        x = None
        for kind, layer, key in self._plan:
            p = self._params[key]
            if kind == "embed":
                x = qtake(p["W"], tokens)[:, None, :]
            elif kind == "posembed":
                idx = seq_lens.clamp(0, layer.max_length - 1)
                x = x + p["P"][idx][:, None, :]
            elif kind == "pertoken":
                x, _ = layer.apply(p, {}, x, train=False, mask=None)
            elif kind == "block":
                x = self._block_decode(layer, p, self._block_index[key], x,
                                       page_table, phys, off, valid, pos)
            else:
                z = qdot(x, p["W"])
                if "b" in p:
                    z = z + p["b"]
                x = z
        return x[:, 0, :]

    def _decode_fn(self, page_table, seq_lens, tokens, active, temps,
                   topks, counter: int, sampling: bool):
        """One token for every slot. Returns (sampled (S,), logits (S, V))
        on the device."""
        ops = self._to_device([page_table, seq_lens, tokens, active, topks],
                              [temps] if sampling else [])
        table = ops[0].reshape(page_table.shape)
        logits = self._step_body(table, ops[1], ops[2], ops[3].bool())
        toks = self._sample(logits, ops[5] if sampling else None, ops[4],
                            counter)
        return toks, logits

    def _logits_fn(self, tokens):
        """(B, T) -> (B, T, V) full-sequence pre-softmax logits (parity /
        quality scoring; never on the request path)."""
        return self._forward_tokens(self._params, tokens, None)[0]

    # ------------------------------------------------------ program ledger
    def _meter_program(self, program: str, warmup: bool):
        if program in self._programs:
            return
        self._programs.add(program)
        if warmup:
            self.warmup_runs += 1
            return
        self.request_path_first_runs += 1
        log.warning(
            "decode[%s]: program %s first ran on the REQUEST path (its "
            "first-use costs hit a live stream) — warm() was skipped or "
            "the ladder changed", self.name, program)

    @torch.no_grad()
    def warm(self) -> float:
        """Run every prefill bucket, every chunk bucket, the COW copy and
        the decode step (greedy and sampling) once, so no live stream
        pays a first use. Returns the seconds it took."""
        t0 = time.perf_counter()
        dump_row = np.full((self.cache.pages_per_slot,), kvcache.DUMP_PAGE,
                           np.int64)
        for tb in self.prefill_buckets:
            self._meter_program(f"prefill_{tb}", warmup=True)
            tok, _ = self._prefill_fn(np.zeros((tb,), np.int64), 1,
                                      dump_row, 0.0, 0, 0)
            int(tok)
        # the chunk ladder: suffix prefill after a cache hit and budgeted
        # chunks of a long prompt run through these
        for tb in self.prefill_buckets:
            self._meter_program(f"chunk_{tb}", warmup=True)
            tok, _ = self._chunk_fn(np.zeros((tb,), np.int64), 0, 1,
                                    dump_row, 0.0, 0, 0)
            int(tok)
        # the COW page copy (dump -> dump: page 0 is garbage by contract)
        self._meter_program("cow_copy", warmup=True)
        kvcache.copy_page(self._kpool, self._vpool, kvcache.DUMP_PAGE,
                          kvcache.DUMP_PAGE)
        s = self.cfg.slots
        for sampling in (False, True):
            self._meter_program("decode_sampling" if sampling else "decode",
                                warmup=True)
            toks, _ = self._decode_fn(
                self.cache.page_table, np.zeros((s,), np.int32),
                np.zeros((s,), np.int32), np.zeros((s,), bool),
                np.ones((s,), np.float32), np.full((s,), 5, np.int32), 0,
                sampling)
            toks.cpu()
        return time.perf_counter() - t0

    # ------------------------------------------------------------ host API
    def bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        return self.prefill_buckets[-1]

    @torch.no_grad()
    def admit_prompt(self, prompt: np.ndarray
                     ) -> Optional[kvcache.AdmitInfo]:
        """Token-aware admission: claim a slot, map the longest cached
        prefix read-shared, and resolve any copy-on-write divergence on
        the device. None when slots/pages are exhausted."""
        info = self.cache.admit_prompt(prompt)
        if info is None:
            return None
        if info.cow_src is not None:
            try:
                self._meter_program("cow_copy", warmup=False)
                kvcache.copy_page(self._kpool, self._vpool, info.cow_src,
                                  info.cow_dst)
            except Exception:
                # a failed copy must not leak the slot or the pinned
                # source page — undo the admission before surfacing
                self.cache.release(info.slot)
                self.cache.unref_page(info.cow_src)
                raise
            self.cache.unref_page(info.cow_src)
        return info

    def release_slot(self, slot: int):
        """Release a finished stream's slot (the scheduler's call sites
        use this, never cache.release directly)."""
        self.cache.release(slot)

    @torch.no_grad()
    def prefill_chunk(self, slot: int, prompt: np.ndarray, start: int,
                      n: int, temperature: float, top_k: int) -> int:
        """Run prompt positions [start, start+n) through the chunk program
        into `slot`'s pages (everything before `start` is already cached
        there). Returns the sampled token — meaningful only when this was
        the final chunk (start+n == len(prompt))."""
        tb = self.bucket_for(n)
        toks = np.zeros((tb,), np.int64)
        toks[:n] = prompt[start:start + n]
        self._check_ids(toks[:n])
        self._temps[slot] = temperature
        self._topks[slot] = top_k
        self._counter += 1
        self._meter_program(f"chunk_{tb}", warmup=False)
        tok, _ = self._chunk_fn(toks, start, start + n,
                                self.cache.page_table[slot], temperature,
                                top_k, self._counter)
        tok = int(tok)
        self._last_tokens[slot] = tok
        return tok

    @torch.no_grad()
    def prefill(self, slot: int, prompt: np.ndarray, temperature: float,
                top_k: int) -> Tuple[int, torch.Tensor]:
        """Run the prompt through a bucket-padded prefill into `slot`'s
        pages; returns (first sampled token, last-position logits (V,) on
        the device)."""
        n = int(len(prompt))
        tb = self.bucket_for(n)
        toks = np.zeros((tb,), np.int64)
        toks[:n] = prompt
        self._check_ids(toks[:n])
        self._temps[slot] = temperature
        self._topks[slot] = top_k
        self._counter += 1
        self._meter_program(f"prefill_{tb}", warmup=False)
        tok, logits = self._prefill_fn(toks, n, self.cache.page_table[slot],
                                       temperature, top_k, self._counter)
        tok = int(tok)
        self._last_tokens[slot] = tok
        return tok, logits

    @torch.no_grad()
    def step(self, exclude=()) -> Tuple[np.ndarray, np.ndarray,
                                        torch.Tensor]:
        """One decode iteration over every runnable slot. Returns
        (sampled tokens (S,), runnable mask (S,), logits (S, V) on the
        device); slots not in the mask were inactive, excluded
        (mid-prefill), page-stalled, or at the context cap and produced
        garbage. The sampled tokens' copy back is the step's one
        synchronisation."""
        act = np.zeros((self.cfg.slots,), bool)
        excl = frozenset(int(s) for s in exclude)
        for s in self.cache.active_slots():
            if s in excl:
                continue                # prefill still in flight
            if self.cache.ensure_page(s):
                act[s] = True
        self._counter += 1
        sampling = bool((self._temps[act] > 0).any())
        self._meter_program("decode_sampling" if sampling else "decode",
                            warmup=False)
        toks, logits = self._decode_fn(
            self.cache.page_table, self.cache.seq_lens, self._last_tokens,
            act, self._temps, self._topks, self._counter, sampling)
        toks_np = toks.cpu().numpy().astype(np.int32)
        for s in np.nonzero(act)[0]:
            self.cache.advance(int(s))
            self._last_tokens[s] = toks_np[s]
        self.steps += 1
        return toks_np, act, logits

    @torch.no_grad()
    def logits_full(self, tokens) -> np.ndarray:
        """(B, T) -> (B, T, V) float32 logits by full-sequence recompute
        (the parity oracle and the quantization-quality probe)."""
        tokens = np.asarray(tokens, np.int64)
        self._check_ids(tokens)
        out = self._logits_fn(torch.from_numpy(tokens).to(self.device))
        return out.to(torch.float32).cpu().numpy()

    def close(self):
        """Release the page pools (the engine is retired)."""
        self._kpool = self._vpool = None
        self._params = None

    def describe(self) -> dict:
        d = self.cache.describe()
        d.update({"prefill_buckets": list(self.prefill_buckets),
                  "quantize": self.cfg.quantize,
                  "vocab_size": self.vocab,
                  "n_layers": self.n_layers,
                  "prefill_chunk_tokens": self.prefill_chunk_tokens,
                  "device": str(self.device),
                  "steps": self.steps,
                  "request_path_first_runs": self.request_path_first_runs})
        return d


# ==========================================================================
# The scheduler: iteration-level admission over one or more engines
# ==========================================================================
class _PrefillJob:
    """Admission-to-first-token state for one slot: the uncached suffix
    [pos, len(prompt)) still to prefill, run in budgeted chunks between
    decode steps."""

    __slots__ = ("req", "pos", "chunks", "tok")

    def __init__(self, req: GenerateRequest, pos: int):
        self.req = req
        self.pos = pos
        self.chunks = 0
        self.tok: Optional[int] = None


class _EngineRun:
    """A live engine + the requests bound to its slots. `admitting` is
    True only for the newest engine; older runs drain and retire.
    `prefill` holds slots whose suffix prefill is still chunking (FIFO:
    insertion order is admission order)."""

    __slots__ = ("engine", "version", "admitting", "slot_req", "prefill")

    def __init__(self, engine: DecodeEngine, version: int):
        self.engine = engine
        self.version = version
        self.admitting = True
        self.slot_req: Dict[int, GenerateRequest] = {}
        self.prefill: "OrderedDict[int, _PrefillJob]" = OrderedDict()


class DecodeScheduler:
    """The continuous-batching loop: admit between steps, step every
    engine with live slots, retire drained engines. One daemon thread;
    every device call happens on it.

    `stats` counts joins into a running batch and rejections."""

    def __init__(self, name: str, queue_limit: int = 64):
        self.name = name
        self.queue_limit = int(queue_limit)
        self._pending: deque = deque()
        self._plock = threading.Lock()
        self._runs: List[_EngineRun] = []
        self._rlock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._draining = False
        self.stats = {"preempted_joins": 0, "rejected_queue_full": 0,
                      "rejected_deadline": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"DecodeScheduler-{name}")
        self._started = False

    # -------------------------------------------------------------- control
    def install(self, engine: DecodeEngine, version: int):
        """Make `engine` the admitting engine; older runs stop admitting
        and retire once their in-flight sequences finish."""
        with self._rlock:
            for run in self._runs:
                run.admitting = False
            self._runs.append(_EngineRun(engine, version))
        if not self._started:
            self._started = True
            self._thread.start()
        self._wake.set()

    def submit(self, req: GenerateRequest):
        if self._draining or self._stop.is_set():
            raise ServerDrainingError(
                f"decode[{self.name}] is shutting down")
        with self._plock:
            if len(self._pending) >= self.queue_limit:
                self.stats["rejected_queue_full"] += 1
                raise ServerOverloadedError(
                    f"decode[{self.name}]: join queue full "
                    f"({self.queue_limit} pending)")
            self._pending.append(req)
        self._wake.set()

    def queue_state(self) -> Tuple[int, int]:
        with self._plock:
            return len(self._pending), self.queue_limit

    def inflight(self) -> int:
        with self._rlock:
            return sum(len(r.slot_req) + len(r.prefill)
                       for r in self._runs)

    def admitting_engine(self) -> Optional[DecodeEngine]:
        with self._rlock:
            if self._runs and self._runs[-1].admitting:
                return self._runs[-1].engine
            return None

    # --------------------------------------------------------------- loop
    def _loop(self):
        crash: Optional[Exception] = None
        while not self._stop.is_set():
            try:
                worked = self._admit()
                worked = self._prefill_tick() or worked
                worked = self._step_all() or worked
                self._retire()
            except Exception as e:      # noqa: BLE001 — the scheduler
                # thread is the only place slots are reclaimed: an
                # unguarded exception here would strand every stream
                # forever while the servable still reported "ready".
                # Fail everything loudly and stop instead.
                crash = e
                log.exception("decode[%s]: scheduler crashed; failing "
                              "all streams", self.name)
                self._stop.set()
                break
            if not worked:
                self._wake.wait(0.005)
                self._wake.clear()
        # teardown: everything still live gets a terminal error
        exc = crash if crash is not None else ServerDrainingError(
            f"decode[{self.name}] shut down mid-stream")
        with self._rlock:
            runs = list(self._runs)
            self._runs.clear()
        for run in runs:
            for slot, job in run.prefill.items():
                run.engine.release_slot(slot)
                job.req.fail(exc)
            for slot, req in run.slot_req.items():
                run.engine.release_slot(slot)
                req.fail(exc)
            run.engine.close()
        self._fail_pending(crash if crash is not None
                           else ServerDrainingError(
                               f"decode[{self.name}] shut down"))

    def _fail_pending(self, exc: Exception):
        while True:
            with self._plock:
                if not self._pending:
                    return
                req = self._pending.popleft()
            req.fail(exc)

    def _admit(self) -> bool:
        with self._rlock:
            run = self._runs[-1] if self._runs and self._runs[-1].admitting \
                else None
        if run is None:
            return False
        worked = False
        while True:
            with self._plock:
                req = self._pending[0] if self._pending else None
            if req is None:
                break
            if req.cancelled.is_set():
                self._pop(req)
                req.finish("cancelled")
                continue
            if req.deadline is not None \
                    and time.monotonic() > req.deadline:
                self._pop(req)
                self.stats["rejected_deadline"] += 1
                req.fail(DeadlineExceededError(
                    f"decode[{self.name}]: deadline expired after "
                    f"{time.monotonic() - req.enqueued:.3f}s in queue"))
                continue
            if len(req.prompt) >= run.engine.max_context:
                self._pop(req)
                req.fail(ValueError(
                    f"decode[{self.name}]: prompt length "
                    f"{len(req.prompt)} leaves no room to generate "
                    f"(live max_context {run.engine.max_context})"))
                continue
            try:
                info = run.engine.admit_prompt(req.prompt)
            except Exception as e:          # noqa: BLE001 — surfaced to req
                self._pop(req)
                log.exception("decode[%s]: admission failed", self.name)
                req.fail(e)
                continue
            if info is None:
                break                       # no slot/pages; retry next tick
            self._pop(req)
            # admission is cheap (page-table writes + at most one COW
            # page copy; the suffix prefill runs in budgeted chunks on
            # the next _prefill_tick), so this loop keeps draining the
            # join queue until slots, pages or the queue are exhausted
            req.cached_tokens = int(info.cached_len)
            # "joined a RUNNING batch" counts decoding streams only
            with self._rlock:
                joined_running = any(r.slot_req for r in self._runs)
            req.version = run.version
            run.prefill[info.slot] = _PrefillJob(req, int(info.cached_len))
            if joined_running:
                self.stats["preempted_joins"] += 1
            worked = True
        return worked

    def _pop(self, req: GenerateRequest):
        with self._plock:
            if self._pending and self._pending[0] is req:
                self._pending.popleft()

    def _prefill_tick(self) -> bool:
        """Advance every in-flight prefill by at most the engine's
        per-tick token budget (FIFO across that engine's jobs), then
        return to the loop so a decode step can interleave. Chunking off
        (budget 0) completes each job in one call. The final chunk
        yields the first token."""
        with self._rlock:
            runs = [r for r in self._runs if r.prefill]
        worked = False
        for run in runs:
            budget = run.engine.prefill_chunk_tokens
            spent = 0
            for slot in list(run.prefill.keys()):
                job = run.prefill.get(slot)
                if job is None:
                    continue
                req = job.req
                if req.cancelled.is_set():
                    run.prefill.pop(slot, None)
                    self._finish(run, slot, req, "cancelled")
                    worked = True
                    continue
                if req.deadline is not None \
                        and time.monotonic() > req.deadline:
                    run.prefill.pop(slot, None)
                    self._finish(run, slot, req, "deadline")
                    worked = True
                    continue
                total = len(req.prompt)
                try:
                    while job.pos < total:
                        if budget > 0 and spent >= budget:
                            break
                        n = total - job.pos if budget <= 0 \
                            else min(total - job.pos, budget - spent)
                        if job.pos == 0 and n == total:
                            # cold, whole prompt within budget: the dense
                            # program (also what cache-off runs)
                            tok, _ = run.engine.prefill(
                                slot, req.prompt, req.temperature,
                                req.top_k)
                        else:
                            tok = run.engine.prefill_chunk(
                                slot, req.prompt, job.pos, n,
                                req.temperature, req.top_k)
                        job.pos += n
                        job.chunks += 1
                        spent += n
                        worked = True
                        if job.pos >= total:
                            job.tok = tok
                except Exception as e:  # noqa: BLE001 — surfaced to req
                    run.prefill.pop(slot, None)
                    run.engine.release_slot(slot)
                    log.exception("decode[%s]: prefill failed", self.name)
                    req.fail(e)
                    continue
                if job.pos >= total:
                    run.prefill.pop(slot, None)
                    req.prefill_chunks = job.chunks
                    # prefill complete: every mapped prompt page holds
                    # final K/V — only now may the prefix index share it
                    run.engine.cache.register_prefix(slot, req.prompt)
                    run.slot_req[slot] = req
                    self._emit(run, slot, req, job.tok)
        return worked

    def _emit(self, run: _EngineRun, slot: int, req: GenerateRequest,
              tok: int):
        """Deliver one sampled token; finish/free the slot on EOS, the
        token budget, cancellation or the deadline."""
        if req.cancelled.is_set():
            self._finish(run, slot, req, "cancelled")
            return
        if req.deadline is not None and time.monotonic() > req.deadline:
            self._finish(run, slot, req, "deadline")
            return
        if req.eos_id is not None and tok == req.eos_id:
            self._finish(run, slot, req, "eos")
            return
        req.emit(tok)
        if req.n_emitted >= req.max_new_tokens:
            self._finish(run, slot, req, "length")

    def _finish(self, run: _EngineRun, slot: int, req: GenerateRequest,
                reason: str):
        run.engine.release_slot(slot)
        run.slot_req.pop(slot, None)
        req.finish(reason)

    def _step_all(self) -> bool:
        with self._rlock:
            runs = [r for r in self._runs if r.slot_req]
        worked = False
        for run in runs:
            toks, act, _ = run.engine.step(exclude=set(run.prefill.keys()))
            for slot, req in list(run.slot_req.items()):
                if act[slot]:
                    self._emit(run, slot, req, int(toks[slot]))
                elif int(run.engine.cache.seq_lens[slot]) \
                        >= run.engine.max_context:
                    self._finish(run, slot, req, "length_cap")
                elif req.cancelled.is_set():
                    # a page-stalled slot must still honor cancellation/
                    # deadline: releasing it is what refills the pool —
                    # otherwise an oversubscribed pool where EVERY slot
                    # stalls deadlocks forever with all pages leaked
                    self._finish(run, slot, req, "cancelled")
                elif req.deadline is not None \
                        and time.monotonic() > req.deadline:
                    self._finish(run, slot, req, "deadline")
                # else: page-stalled this step (counted by the cache)
            worked = True
        return worked

    def _retire(self):
        with self._rlock:
            keep = []
            for run in self._runs:
                if not run.admitting and not run.slot_req \
                        and not run.prefill:
                    run.engine.close()
                    log.info("decode[%s]: retired engine v%d (drained)",
                             self.name, run.version)
                else:
                    keep.append(run)
            self._runs = keep

    # -------------------------------------------------------------- drain
    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting, let in-flight sequences finish (bounded), then
        stop the loop. Queued joins fail with a draining error."""
        self._draining = True
        self._fail_pending(ServerDrainingError(
            f"decode[{self.name}] is draining"))
        deadline = time.monotonic() + timeout
        while self.inflight() and time.monotonic() < deadline:
            time.sleep(0.01)
        flushed = self.inflight() == 0
        self._stop.set()
        self._wake.set()
        if self._started:
            self._thread.join(timeout=max(0.1,
                                          deadline - time.monotonic() + 5))
        return flushed


# ==========================================================================
# The servable: engine + scheduler behind the registry surface
# ==========================================================================
class ServedLM:
    """One named decode servable: a warmed engine and its scheduler.

    The LM sibling of registry.ServedModel (status / describe / shutdown),
    so the registry and the HTTP server drive both kinds alike. Version
    swaps and rollback are not ported yet."""

    kind = "lm"

    def __init__(self, name: str, model, source: str,
                 decode: Optional[DecodeConfig] = None):
        self.name = name
        self.cfg = decode if decode is not None else DecodeConfig()
        self.status = "loading"
        self.model = model
        self.source = str(source)
        self.version = 1
        self.loaded_at = time.time()
        engine = DecodeEngine(model, self.cfg, name=name)
        self.warmup_seconds = engine.warm()
        self.vocab = engine.vocab
        self.max_context = engine.max_context
        self.scheduler = DecodeScheduler(name,
                                         queue_limit=self.cfg.queue_limit)
        self.scheduler.install(engine, version=self.version)
        #: request-path snapshot of the active version's metadata
        self.active_info = self._version_info()
        self.status = "ready"

    def _version_info(self) -> dict:
        return {"version": self.version, "source": self.source,
                "loaded_at": self.loaded_at,
                "model_class": type(self.model).__name__,
                "device": str(self.model.device)}

    # ---------------------------------------------------------- generation
    def generate(self, prompt, max_new_tokens: int = 32,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: Optional[int] = None,
                 deadline: Optional[float] = None) -> GenerateRequest:
        """Validate + enqueue one generation; returns the live request
        whose `events` queue streams tokens. Raises ValueError (400),
        ServerOverloadedError (429) or ServerDrainingError (503). Every
        id is checked here, before any reaches a device gather."""
        if self.status == "stopping":
            raise ServerDrainingError(
                f"decode[{self.name}] is draining")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must contain at least one token id")
        if prompt.size >= self.max_context:
            raise ValueError(
                f"prompt length {prompt.size} leaves no room to generate "
                f"(max_context {self.max_context})")
        if prompt.min() < 0 or prompt.max() >= self.vocab:
            raise ValueError(
                f"prompt ids must be in [0, {self.vocab}); got "
                f"[{int(prompt.min())}, {int(prompt.max())}]")
        if max_new_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        max_new = min(int(max_new_tokens), self.cfg.max_new_tokens_cap,
                      self.max_context - int(prompt.size))
        req = GenerateRequest(
            prompt, max_new_tokens=max_new, temperature=temperature,
            top_k=top_k, eos_id=eos_id,
            deadline=None if deadline is None
            else time.monotonic() + float(deadline))
        self.scheduler.submit(req)
        return req

    # ------------------------------------------------------------ lifecycle
    def swap(self, source, keep_versions: int = 3) -> dict:
        raise NotImplementedError(
            f"decode[{self.name}]: version swaps of LM servables are not "
            "yet ported to the PyTorch package")

    def rollback(self) -> dict:
        raise NotImplementedError(
            f"decode[{self.name}]: rollback of LM servables is not yet "
            "ported to the PyTorch package")

    # --------------------------------------------------------------- admin
    def queue_state(self) -> Tuple[int, int]:
        """(depth, limit) of the join queue — the Retry-After input."""
        return self.scheduler.queue_state()

    def describe(self) -> dict:
        newest = self.scheduler.admitting_engine()
        d = {
            "name": self.name,
            "kind": self.kind,
            "status": self.status,
            "vocab_size": self.vocab,
            "max_context": self.max_context,
            "active_version": self.version,
            "versions": [self._version_info()],
            "pending": self.scheduler.queue_state()[0],
            "inflight": self.scheduler.inflight(),
        }
        if newest is not None:
            d["decode"] = newest.describe()
        return d

    def shutdown(self, drain: bool = True, timeout: float = 30.0):
        self.status = "stopping"
        self.scheduler.drain(timeout=timeout if drain else 0.1)
