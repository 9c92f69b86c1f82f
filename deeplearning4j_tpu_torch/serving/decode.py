"""Token-level continuous batching — the LM decode runtime.

Counterpart of the JAX package's `serving/decode.py`: iteration-level
scheduling (Orca/vLLM) over a paged KV cache (`serving/kvcache.py`).

- **Fixed shapes, warmed at load.** Decode runs over ``slots`` fixed
  batch positions with an active mask; prefill runs per bucket of a
  page-aligned ladder (`kvcache.default_prefill_buckets`), and so does the
  chunk program a cache hit or a long prompt goes through. `warm()` runs
  every program once at load time and, on CUDA, captures each per-token
  program and each prefill/chunk bucket as a `torch.cuda.CUDAGraph` (the
  counterpart of the reference's AOT-compiled programs); the request path
  replays them over static operand buffers. `request_path_first_runs`
  counts any program first run by a live request instead (0 is the
  contract). On the CPU the same functions run eagerly on the same
  operand tensors. The COW page copy and the KV-fabric page transfers
  stay eager: a two-op copy, and host<->device transfers off the
  per-token path.
- **Continuous batching.** `DecodeScheduler` admits queued requests into
  free slots *between token steps*: a late join's prefill lands while
  other sequences keep decoding, in budgeted chunks so one long prompt
  cannot stall every stream.
- **Sampling on the device.** Greedy / temperature / top-k run on the
  logits where they were computed (Gumbel-max, one argmax), so the host
  sees one integer per slot per step: one device-to-host copy, the
  step's only synchronisation.
- **Speculative decoding.** A draft engine (the target's own weights
  through ``int8``/``bf16``, or any same-vocabulary model) proposes k
  tokens per stream; the target scores all k+1 positions as k+1 unrolled
  calls of the one-token step body (so its logits are bitwise those of
  k+1 plain steps); the host accepts by exact argmax prefix match or
  rejection sampling. Two graph replays and one device-to-host copy per
  round.
- **Tiered KV fabric.** Pages extract to and land from sealed frames
  (`kvfabric.py`): the host spill tier demotes evicted prefix pages and
  promotes them back, and `export_prefix`/`import_prefix` move a prefix's
  pages between servers (disaggregated prefill).
- **Rolling hot swap.** A swap builds and warms a complete replacement
  engine off the request path; new admissions go to it while in-flight
  streams finish on the old one (their pages are only meaningful under
  the weights that wrote them). Up to `keep_versions` engines stay
  resident, so a rollback re-admits on a warm engine.

Every attention here is the dense `dot_product_attention` after a page
gather, as in the reference (`decode.py:512,550,585` there): the decode
path launches no hand-written kernel.

Not ported yet: the metrics, flight and goodput hooks (the counters are
plain `stats` dicts and `request_path_first_runs`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import queue
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.monitor import flight
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.layers.attention import (
    EmbeddingSequenceLayer, LayerNormLayer, MoEFeedForward,
    MultiHeadAttention, PositionalEmbeddingLayer, TransformerBlock,
    _merge_heads, _split_heads, dot_product_attention, rope,
)
from deeplearning4j_tpu_torch.nn.layers.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.serving import kvcache, kvfabric
from deeplearning4j_tpu_torch.serving.batcher import (
    DeadlineExceededError, ServerDrainingError, ServerOverloadedError,
)
from deeplearning4j_tpu_torch.serving.quantize import (
    QUANT_MODES, is_spec_variant, parse_variant, qdot, qtake,
    quantize_params,
)
from deeplearning4j_tpu_torch.serving.registry import (
    ModelLoadError, ServableVersion, load_servable,
)
from deeplearning4j_tpu_torch.util.locks import DiagnosedLock

log = logging.getLogger("deeplearning4j_tpu_torch")

_TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10)
_ITL_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1)

_LN = LayerNormLayer()          # the block-internal LN (default epsilon)

#: static ceiling for the top-k gate (per-request k is clipped)
TOP_K_MAX = 64


def _device_scope(device: torch.device):
    """Make `device` the current CUDA device for the calls inside (a no-op
    on the CPU): the HTTP thread that warms a swap and the scheduler
    thread that steps must both launch on the servable's card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


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
    #: speculative decoding (draft-verify): None = off. "int8"/"bf16"
    #: self-draft the target through a quantized variant of its own
    #: params; any other string is loaded as a servable source (it must
    #: serve the SAME vocab — a mismatch is a loud ModelLoadError). The
    #: ``@spec[:draft=...,k=...]`` source suffix sets these per servable.
    spec_draft: Optional[str] = None
    spec_k: int = 4                      # draft tokens per verify round
    #: rolling acceptance-rate floor: over the last `spec_window` rounds
    #: of a stream, accepted/proposed below this turns speculation OFF
    #: for that stream (it plain-decodes to completion)
    spec_accept_floor: float = 0.4
    spec_window: int = 8                 # rounds in the acceptance window
    #: draft engine's page pool (its own second pool); None = derived
    #: like the target's (no oversubscription)
    spec_draft_pool_pages: Optional[int] = None
    #: host-RAM spill tier size in pages: zero-ref retained prefix pages
    #: demote here under device pool pressure and promote back on a hit.
    #: None/0 = off. Only the TARGET engine spills (the draft's cache is
    #: derivative)
    spill_pages: Optional[int] = None


def apply_variant(cfg: DecodeConfig, variant: Optional[str]) -> DecodeConfig:
    """Apply a parsed ``@<variant>`` source suffix to a DecodeConfig:
    ``int8``/``bf16`` select quantized weights, ``spec[:k=...,draft=...,
    floor=...,window=...,pool_pages=...]`` turns on speculative decoding
    (unset options keep the config's defaults)."""
    if variant is None:
        return cfg
    if variant in QUANT_MODES:
        return dataclasses.replace(cfg, quantize=variant)
    if is_spec_variant(variant):
        updates = {"spec_draft": cfg.spec_draft or "int8"}
        if variant.startswith("spec:"):
            for item in variant[len("spec:"):].split(","):
                if not item:
                    continue
                key, sep, val = item.partition("=")
                if not sep:
                    raise ValueError(
                        f"@spec option {item!r} is not key=value")
                if key == "draft":
                    updates["spec_draft"] = val
                elif key == "k":
                    updates["spec_k"] = int(val)
                elif key == "floor":
                    updates["spec_accept_floor"] = float(val)
                elif key == "window":
                    updates["spec_window"] = int(val)
                elif key == "pool_pages":
                    updates["spec_draft_pool_pages"] = int(val)
                else:
                    raise ValueError(
                        f"unknown @spec option {key!r}; known: draft, k, "
                        "floor, window, pool_pages")
        return dataclasses.replace(cfg, **updates)
    raise ValueError(f"unknown servable variant {variant!r}; known: "
                     f"{QUANT_MODES} or spec[:...]")


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
        self.last_emit_at: Optional[float] = None
        self.n_emitted = 0
        self.version: Optional[int] = None
        self.finish_reason: Optional[str] = None
        #: prompt positions served from the shared prefix cache (set at
        #: admission) and prefill calls it took to cover the uncached
        #: suffix (set when prefill completes)
        self.cached_tokens = 0
        self.prefill_chunks = 0
        #: speculative-decoding accounting for THIS stream: draft tokens
        #: proposed to / accepted by the verifier, and verify rounds run
        #: (0/0/0 on plain decode)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_rounds = 0
        self.cancelled = threading.Event()
        self.done = threading.Event()
        # the submitting thread's trace context (the HTTP handler binds
        # the request's ctx around generate()); the scheduler thread
        # records this stream's spans under it
        self.ctx = monitor.current_context()
        self.t0_pc = time.perf_counter()
        self._last_pc: Optional[float] = None

    # ------------------------------------------------------------- events
    def emit(self, token: int):
        self.n_emitted += 1
        now = time.monotonic()
        if self.first_token_at is None:
            self.first_token_at = now
        self.last_emit_at = now
        self._last_pc = time.perf_counter()
        self.events.put(("token", int(token)))

    def finish(self, reason: str):
        if self.done.is_set():
            return
        self.finish_reason = reason
        self.done.set()
        self.events.put(("done", {
            "finish_reason": reason,
            "tokens": self.n_emitted,
            "version": self.version,
            "cached_tokens": self.cached_tokens,
            "prefill_chunks": self.prefill_chunks,
            "spec_proposed": self.spec_proposed,
            "spec_accepted": self.spec_accepted,
            "spec_rounds": self.spec_rounds,
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
# Static program operands and the sampling noise
# ==========================================================================
_M32 = 0xFFFFFFFF
_FLOAT_OPERANDS = ("temps", "ptemp")        # carried as float64 bits


def _mix32(h):
    """A 32-bit avalanche of values in [0, 2^32) (murmur3's finalizer
    shape, with multipliers below 2^31 so no int64 product overflows), on
    Python ints and int64 tensors alike."""
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & _M32
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & _M32
    return h ^ (h >> 16)


def gumbel_noise(seed: int, counter, shape, device) -> torch.Tensor:
    """Gumbel(0, 1) noise of `shape`, a pure function of (seed, counter,
    element index): two rounds of a 32-bit integer hash in tensor ops (no
    generator state, so a captured graph replays it for whatever counter
    its operands hold, bitwise the eager call), 23 bits of it as a
    uniform u in (0, 1), then -log(-log(u)). `counter` is an int or a 0-d
    int64 tensor."""
    key = _mix32(torch.as_tensor(counter, dtype=torch.int64, device=device)
                 & _M32)
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    h = _mix32(_mix32(idx ^ key) ^ _mix32(int(seed) & _M32))
    u = ((h >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)
    return -torch.log(-torch.log(u))


class _Operands:
    """The static operands of one engine's programs: one int64 buffer on
    the engine's device, read by every program (and by every captured
    graph) through fixed views, and written before each program run from a
    host mirror in ONE copy of the program's section ("step": the decode,
    propose and verify operands; "prompt": the prefill and chunk ones).
    Float operands travel as float64 bits.

    On CUDA the mirror is pinned and the copy non_blocking. The mirror is
    rewritten only by the next program's staging, and every program run
    ends in a host synchronisation before that (the sampled tokens' copy
    back in `step`, `prefill` and `prefill_chunk`; the round's one copy in
    `spec_step`, after the draft's and the target's programs, which stage
    into two engines' mirrors; the read-back after each program in
    `warm`), so a copy has completed before its source is overwritten. On
    the CPU the mirror is the buffer itself."""

    def __init__(self, slots: int, pages: int, max_tokens: int,
                 device: torch.device):
        sections = {
            "step": (("table", slots * pages), ("lens", slots),
                     ("tokens", slots), ("active", slots), ("topks", slots),
                     ("rows", slots), ("counter", 0), ("temps", slots)),
            "prompt": (("ptoks", max_tokens), ("prow", pages), ("start", 0),
                       ("end", 0), ("ptopk", 1), ("pcounter", 0),
                       ("ptemp", 1))}
        self._at: Dict[str, Tuple[int, int, bool]] = {}
        self._sections: Dict[str, Tuple[int, int]] = {}
        at = 0
        for section, fields in sections.items():
            first = at
            for name, size in fields:
                # size 0: a 0-d scalar operand (one element)
                self._at[name] = (at, max(size, 1), size == 0)
                at += max(size, 1)
            self._sections[section] = (first, at)
        self.device = device
        self.dev = torch.zeros((at,), dtype=torch.int64, device=device)
        self._pinned = None
        if device.type == "cuda":
            self._pinned = torch.zeros((at,), dtype=torch.int64,
                                       pin_memory=True)
            self.host = self._pinned.numpy()
        else:
            self.host = self.dev.numpy()
        for name, (i, size, scalar) in self._at.items():
            view = self.dev[i] if scalar else self.dev[i:i + size]
            if name in _FLOAT_OPERANDS:
                view = view.view(torch.float64)
            setattr(self, name, view)
        self.table = self.table.view(slots, pages)
        self._proposals: Dict[int, torch.Tensor] = {}

    def put(self, name: str, value):
        """Write one operand's host value (an array's leading elements, or
        a scalar) into the mirror."""
        i, _, _ = self._at[name]
        dtype = np.float64 if name in _FLOAT_OPERANDS else np.int64
        a = np.asarray(value, dtype).reshape(-1)
        self.host[i:i + a.size] = a.view(np.int64)

    def load(self, section: str):
        """The section's mirror -> the device buffer (a no-op on the
        CPU, where they are one)."""
        if self._pinned is not None:
            a, b = self._sections[section]
            self.dev[a:b].copy_(self._pinned[a:b], non_blocking=True)

    def proposal(self, k: int) -> torch.Tensor:
        """The static (slots, k) buffer a propose program writes its
        tokens into and a verify program reads (allocated on first use,
        outside any capture)."""
        buf = self._proposals.get(k)
        if buf is None:
            buf = torch.zeros((self.table.shape[0], k), dtype=torch.int64,
                              device=self.device)
            self._proposals[k] = buf
        return buf
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
        # the programs' static operands and (on CUDA) their captured graphs:
        # program name -> (graph, outputs), in one memory pool per engine
        self._ops = _Operands(cfg.slots, self.cache.pages_per_slot,
                              max(self.prefill_buckets), self.device)
        self._graphs: Dict[str, Tuple[object, object]] = {}
        self._pool = self._side = None
        self._pool_bytes: Optional[int] = 0
        self.graph_stats = {"captures": 0, "capture_s": 0.0, "replays": 0}
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
        self._closed = False
        #: set by the servable while this engine is one of its resident
        #: versions: the scheduler then leaves it open after draining, so
        #: a rollback re-admits on it warm
        self.resident = False
        # ---------------------------------------------- tiered KV fabric
        #: pinned host staging for page lands (CUDA only): a ring of
        #: buffers, each reused only after the event of its last copy
        self._stage: List[Tuple[torch.Tensor, Optional[object]]] = []
        self._stage_next = 0
        self.fabric = {"demoted": 0, "demote_s": 0.0, "landed": 0,
                       "land_s": 0.0, "exported": 0, "imported": 0}
        self.spill: Optional[kvfabric.HostPageStore] = None
        if cfg.spill_pages and int(cfg.spill_pages) > 0 \
                and cfg.prefix_cache:
            self.spill = kvfabric.HostPageStore(
                int(cfg.spill_pages),
                kvfabric.frame_capacity(self.n_layers, cfg.page_size,
                                        self.n_heads, self.head_dim,
                                        self._dtype),
                name=name)
            self.cache.attach_spill(self.spill, self._demote_page,
                                    self._land_frame)
        # ---------------------------------------- speculative decoding
        # the draft is a full second engine (own params, own page pool,
        # own programs under "<name>.draft"); the target keeps per-slot
        # speculation state and the slot mapping
        self.draft: Optional["DecodeEngine"] = None
        self._draft_slots: Dict[int, Optional[int]] = {}
        self._draft_origin: Dict[int, int] = {}
        self._spec_on = np.ones((cfg.slots,), bool)
        self._spec_hist = [deque(maxlen=max(1, int(cfg.spec_window)))
                           for _ in range(cfg.slots)]
        # host-side rejection/residual sampling stream (the draft's
        # device sampler provides q; acceptance runs on the host), the
        # reference's stream exactly
        self._spec_rng = np.random.RandomState((cfg.seed ^ 0x5EC5) &
                                               0x7FFFFFFF)
        #: per-round accounting: rounds, proposed/accepted draft tokens,
        #: host synchronisations (one copy back a round)
        self.spec_stats = {"rounds": 0, "proposed": 0, "accepted": 0,
                           "host_syncs": 0, "fallbacks": {}}
        if cfg.spec_draft is not None:
            try:
                self._build_draft(model)
            except Exception:
                self.close()
                raise

    def _build_draft(self, model):
        """Construct the speculative draft engine. ``spec_draft`` is a
        quantize mode (self-draft: the target's own params, int8/bf16) or
        any servable source with the SAME vocabulary — a mismatched draft
        would run every acceptance test over a different symbol set, so
        it is rejected loudly here, at deploy/swap time."""
        cfg = self.cfg
        k = int(cfg.spec_k)
        if k < 1:
            raise ModelLoadError(
                f"decode[{self.name}]: spec_k must be >= 1 (got {k})")
        src = str(cfg.spec_draft)
        if src in QUANT_MODES:
            draft_model, dquant, dsrc = model, src, f"self@{src}"
        else:
            base, dquant = parse_variant(src)
            draft_model, dsrc = load_servable(base, device=self.device), src
        dcfg = dataclasses.replace(
            cfg, quantize=dquant, max_context=self.max_context,
            pool_pages=cfg.spec_draft_pool_pages, spec_draft=None,
            spill_pages=None, seed=cfg.seed + 1)
        draft = DecodeEngine(draft_model, dcfg, name=f"{self.name}.draft")
        if draft.vocab != self.vocab:
            dvocab = draft.vocab
            draft.close()
            raise ModelLoadError(
                f"decode[{self.name}]: speculative draft {dsrc!r} has "
                f"vocab {dvocab}, target serves {self.vocab} — rejection "
                "sampling needs one symbol set (deploy a matching-vocab "
                "draft, or fix the tokenizer mismatch upstream)")
        self.draft = draft

    @property
    def spec_enabled(self) -> bool:
        return self.draft is not None

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
    def _sample(self, logits, temps, topks, counter):
        """Greedy / temperature / top-k per row (Gumbel-max: one argmax
        whatever the temperature). temps/topks None means every row is
        greedy, and the noise is not drawn. `counter` is an int or a 0-d
        int64 tensor on the logits' device."""
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
        g = gumbel_noise(self.cfg.seed, counter, lg.shape, lg.device)
        hot = temps > 0
        safe_t = torch.where(hot, temps, torch.ones_like(temps))[:, None]
        sampled = torch.argmax(filt / safe_t + g, dim=-1)
        return torch.where(hot, sampled, greedy)

    # The program bodies below take every operand as a tensor on the
    # pools' device (0-d int64 tensors for scalars) and read no value on
    # the host: on CUDA each is captured once and replayed over the static
    # operand buffers; on the CPU the same function runs eagerly on them.
    def _prefill_fn(self, tokens, length, page_row, temps, topks, counter):
        """tokens (Tb,) bucket-padded, the first `length` (0-d) real;
        page_row (pages_per_slot,); temps/topks (1,) (temps None: greedy).
        Returns (first sampled token (), last-position logits (V,))."""
        tb = tokens.shape[0]
        mask = (torch.arange(tb, device=tokens.device)[None]
                < length).to(torch.float32)
        logits, kvs = self._forward_tokens(self._params, tokens[None], mask)
        for li, (k, v) in enumerate(kvs):
            kvcache.write_prompt_kv(self._kpool, self._vpool, li, k[0], v[0],
                                    page_row, self.cfg.page_size)
        at = (length - 1).clamp(0, tb - 1).reshape(1)
        last = logits[0].index_select(0, at)
        return self._sample(last, temps, topks, counter)[0], last[0]

    def _chunk_fn(self, tokens, start, end, page_row, temps, topks,
                  counter):
        """Suffix-chunk prefill: tokens (Tb,) are prompt positions
        [start, end) of one slot (0-d tensors; bucket-padded past
        end - start), with everything before `start` already cached in the
        slot's pages. Returns (sampled token (), last-valid-position logits
        (V,)) — the sample is only meaningful on the final chunk."""
        tb = tokens.shape[0]
        toks, row = tokens[None], page_row
        pos = start + torch.arange(tb, device=tokens.device)
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
        at = (end - 1 - start).clamp(0, tb - 1).reshape(1)
        last = x[0].index_select(0, at)
        return self._sample(last, temps, topks, counter)[0], last[0]

    def _step_body(self, page_table, seq_lens, tokens, active):
        """The one-token decode forward over every slot (inactive slots
        compute masked garbage into the dump page). Returns logits
        (S, V)."""
        ps = self.cfg.page_size
        dev = seq_lens.device
        slots = torch.arange(seq_lens.shape[0], device=dev)
        # a slot at the context cap is inactive; clamp keeps its (unused)
        # page lookup in range
        page_idx = (seq_lens // ps).clamp_max(page_table.shape[1] - 1)
        phys = torch.where(active, page_table[slots, page_idx],
                           torch.zeros_like(page_idx))  # DUMP_PAGE
        off = seq_lens % ps
        # validity: cached positions 0..seq_len INCLUSIVE (the row this
        # step appends is position seq_len)
        valid = (torch.arange(self.max_context, device=dev)[None, :]
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
                   topks, counter):
        """One token for every slot (temps None: every slot greedy).
        Returns (sampled (S,), logits (S, V))."""
        logits = self._step_body(page_table, seq_lens, tokens, active)
        return self._sample(logits, temps, topks, counter), logits

    def _verify_fn(self, page_table, seq_lens, tokens, drafted, active):
        """The speculative verify: score k+1 positions per slot —
        position 0 consumes the stream's last sampled token, positions
        1..k the draft's proposals (device tensors, never fetched first)
        — writing each position's K/V as it goes (rejected-tail rows land
        past the post-acceptance seq_len; the validity mask hides them
        until the next round overwrites). k+1 unrolled `_step_body`
        calls, NOT one chunk over (S, k+1): other shapes would let cuBLAS
        pick other algorithms, and per-position logits must be bitwise
        those of k+1 sequential decode steps. Returns logits
        (S, k+1, V)."""
        k = drafted.shape[1]
        outs = []
        tok = tokens
        for i in range(k + 1):
            outs.append(self._step_body(page_table, seq_lens + i, tok,
                                        active))
            if i < k:
                tok = drafted[:, i]
        return torch.stack(outs, dim=1)

    def _spec_propose_fn(self, page_table, seq_lens, tokens, active, temps,
                         topks, counter, drafted):
        """The draft's propose program: k = drafted.shape[1] autoregressive
        tokens per slot (sampled on the device, each fed to the next
        position; position i draws its noise from counter + i), written
        into `drafted` (S, k), plus one extra body that consumes the k-th
        sample so the draft cache covers every token the target may accept
        — the next round then always resumes from exactly one new token
        wherever acceptance stopped. temps None means every slot is greedy.
        Returns (drafted, draft logits (S, k, V)); the logits give the
        host's rejection sampler its q distribution."""
        k = drafted.shape[1]
        toks, qlogits = [], []
        tok = tokens
        for i in range(k):
            logits = self._step_body(page_table, seq_lens + i, tok, active)
            tok = self._sample(logits, temps, topks, counter + i)
            toks.append(tok)
            qlogits.append(logits)
        self._step_body(page_table, seq_lens + k, tok, active)
        torch.stack(toks, dim=1, out=drafted)
        return drafted, torch.stack(qlogits, dim=1)

    # ---------------------------------------------- staging and dispatch
    def _stage_step(self, tokens, active, temps=None, topks=None,
                    counter: int = 0, rows=None):
        """This engine's page table and lengths plus the given per-slot
        operands -> the step section of the static buffers."""
        o = self._ops
        o.put("table", self.cache.page_table)
        o.put("lens", self.cache.seq_lens)
        o.put("tokens", tokens)
        o.put("active", active)
        o.put("counter", counter)
        if temps is not None:
            o.put("temps", temps)
            o.put("topks", topks)
        if rows is not None:
            o.put("rows", rows)
        o.load("step")

    def _decode(self, tokens, active, temps, topks, counter: int,
                sampling: bool):
        """Host operands -> the `decode[_sampling]` program. Returns
        (sampled (S,), logits (S, V)) on the device."""
        o = self._ops
        self._stage_step(tokens, active, temps, topks, counter)
        return self._run(
            "decode_sampling" if sampling else "decode",
            lambda: self._decode_fn(o.table, o.lens, o.tokens,
                                    o.active.bool(),
                                    o.temps.float() if sampling else None,
                                    o.topks, o.counter))

    def _prompt(self, program: str, tokens: np.ndarray, start: int,
                end: int, page_row: np.ndarray, temp: float, topk: int,
                counter: int):
        """Host operands -> a `prefill_{tb}` or `chunk_{tb}` program (tb =
        len(tokens)). Both always take the sampling operands: one graph a
        bucket, whose greedy rows return the argmax."""
        o = self._ops
        tb = int(tokens.shape[0])
        o.put("ptoks", tokens)
        o.put("prow", page_row)
        o.put("start", start)
        o.put("end", end)
        o.put("ptemp", temp)
        o.put("ptopk", topk)
        o.put("pcounter", counter)
        o.load("prompt")
        toks = o.ptoks[:tb]
        if program.startswith("prefill_"):
            return self._run(program, lambda: self._prefill_fn(
                toks, o.end, o.prow, o.ptemp.float(), o.ptopk, o.pcounter))
        return self._run(program, lambda: self._chunk_fn(
            toks, o.start, o.end, o.prow, o.ptemp.float(), o.ptopk,
            o.pcounter))

    def _propose(self, k: int, tokens: np.ndarray, active: np.ndarray,
                 temps: np.ndarray, topks: np.ndarray, counter: int,
                 sampling: bool):
        """Host operands -> the `draft_{k}[_sampling]` program over this
        (draft) engine's page table and lengths. Returns (drafted (S, k):
        this engine's static proposal buffer, which the target's verify
        program reads; draft logits (S, k, V))."""
        o = self._ops
        drafted = o.proposal(k)
        self._stage_step(tokens, active, temps, topks, counter)
        return self._run(
            f"draft_{k}_sampling" if sampling else f"draft_{k}",
            lambda: self._spec_propose_fn(
                o.table, o.lens, o.tokens, o.active.bool(),
                o.temps.float() if sampling else None, o.topks, o.counter,
                drafted))

    def _verify(self, tokens: np.ndarray, active: np.ndarray,
                drafted: torch.Tensor, rows: Optional[np.ndarray] = None):
        """Host operands -> the `verify_{k+1}` program. `drafted` is the
        draft's (S_draft, k) device output; target slot s verifies its row
        `rows[s]` (gathered on the device: the proposals never visit the
        host before the verify). The program reads the draft's static
        proposal buffer (this engine's own without a draft); any other
        tensor is copied into it first, on the device."""
        k = int(drafted.shape[1])
        src = (self.draft if self.draft is not None else self)._ops \
            .proposal(k)
        if drafted is not src:
            src.copy_(drafted)
        s = self.cfg.slots
        rows = np.zeros((s,), np.int64) if rows is None else rows
        self._stage_step(tokens, active, rows=rows)
        o = self._ops
        return self._run(f"verify_{k + 1}", lambda: self._verify_fn(
            o.table, o.lens, o.tokens, src[o.rows], o.active.bool()))

    def _logits_fn(self, tokens):
        """(B, T) -> (B, T, V) full-sequence pre-softmax logits (parity /
        quality scoring; never on the request path)."""
        return self._forward_tokens(self._params, tokens, None)[0]

    # ------------------------------------------------- tiered KV fabric
    def _extract_fn(self, page: int):
        """Read one physical page across every layer -> (K, V) each
        shaped (L, page_size, H, D), still on the device."""
        return self._kpool[:, page], self._vpool[:, page]

    def _staging(self, k: torch.Tensor, v: torch.Tensor):
        """Host (K, V) of one page -> tensors the land copies from: on
        CUDA a pinned buffer of the staging ring, written only once the
        event of its previous copy has completed (a buffer reused while
        its copy is in flight would land the wrong page, silently)."""
        if self.device.type != "cuda":
            return k, v, None
        if not self._stage:
            shape = (2,) + tuple(self._kpool.shape[:1]) \
                + tuple(self._kpool.shape[2:])
            self._stage = [(torch.empty(shape, dtype=self._dtype,
                                        pin_memory=True), None)
                           for _ in range(4)]
        i = self._stage_next
        self._stage_next = (i + 1) % len(self._stage)
        buf, event = self._stage[i]
        if event is not None:
            event.synchronize()
        buf[0].copy_(k)
        buf[1].copy_(v)
        return buf[0], buf[1], i

    def _land_fn(self, page: int, k: torch.Tensor, v: torch.Tensor):
        """Write one (L, page_size, H, D) K/V pair into physical page
        `page`, in place; from pinned staging on CUDA, the copy
        asynchronous."""
        k, v, slot = self._staging(k, v)
        self._kpool[:, page].copy_(k, non_blocking=True)
        self._vpool[:, page].copy_(v, non_blocking=True)
        if slot is not None:
            event = torch.cuda.Event()
            event.record()
            self._stage[slot] = (self._stage[slot][0], event)

    @torch.no_grad()
    def _demote_page(self, page: int, digest: bytes) -> bytes:
        """Spill-extract callback: one device page -> a packed, sealed
        frame. SCHEDULER THREAD ONLY (the thread that drives the
        pools)."""
        self._meter_program("kv_extract", warmup=False)
        t0 = time.perf_counter()
        with monitor.span("serving/kv_extract", model=self.name):
            k, v = self._extract_fn(page)
            frame = kvfabric.pack_page(k, v, digest)  # the copy back syncs
        self.fabric["demoted"] += 1
        self.fabric["demote_s"] += time.perf_counter() - t0
        return frame

    @torch.no_grad()
    def _land_frame(self, page: int, payload: bytes, digest: bytes):
        """Spill-land callback: verify + write one frame into physical
        page `page`. Raises kvfabric.FrameError on corruption or a
        geometry that does not fit this pool — a clean rejection the
        caller degrades from. SCHEDULER THREAD ONLY."""
        t0 = time.perf_counter()
        k, v, _ = kvfabric.unpack_page(payload, expect_digest=digest)
        shape = (self.n_layers, self.cfg.page_size, self.n_heads,
                 self.head_dim)
        if tuple(k.shape) != shape or tuple(v.shape) != shape \
                or k.dtype != self._dtype or v.dtype != self._dtype:
            raise kvfabric.FrameError(
                f"frame geometry {tuple(k.shape)}/{k.dtype} does not fit "
                f"pool {shape}/{self._dtype} (mismatched model or "
                "quantize mode)")
        self._meter_program("kv_land", warmup=False)
        with monitor.span("serving/kv_land", model=self.name):
            self._land_fn(page, k, v)
        self.fabric["landed"] += 1
        self.fabric["land_s"] += time.perf_counter() - t0

    @torch.no_grad()
    def export_pages(self, tokens) -> List[bytes]:
        """Serialize the cached pages covering `tokens`' full blocks
        (which must all be radix-indexed — the caller prefills first)
        into sealed frames for a disaggregated transfer. SCHEDULER
        THREAD ONLY (runs as a fabric job)."""
        _, keys = self.cache._blocks(tokens)
        with self.cache._lock:
            _, pages = self.cache._walk_locked(keys)
            if len(pages) < len(keys):
                raise RuntimeError(
                    f"decode[{self.name}]: prefix fell out of the cache "
                    f"mid-export ({len(pages)}/{len(keys)} blocks "
                    "indexed); retry after re-prefilling")
            digests = kvfabric.chain_digests(keys)
        self._meter_program("kv_extract", warmup=False)
        frames = []
        for page, dig in zip(pages, digests):
            with monitor.span("serving/kv_extract", model=self.name):
                k, v = self._extract_fn(page)
                frames.append(kvfabric.pack_page(k, v, dig))
        self.fabric["exported"] += len(frames)
        return frames

    def import_pages(self, tokens, frames: List[bytes]) -> int:
        """Adopt a shipment of sealed frames as this cache's retained
        prefix pages (the disaggregated-prefill landing). Frame i lands
        for block i through the verified land; corruption raises
        kvfabric.FrameError cleanly. SCHEDULER THREAD ONLY."""
        _, keys = self.cache._blocks(tokens)
        if len(frames) != len(keys):
            raise kvfabric.FrameError(
                f"shipment has {len(frames)} frames for {len(keys)} "
                "full token blocks")
        digests = kvfabric.chain_digests(keys)

        def land(i: int, page: int):
            self._land_frame(page, frames[i], digests[i])

        adopted = self.cache.adopt_pages(tokens, land)
        self.fabric["imported"] += adopted
        return adopted

    # ------------------------------------------------------------ programs
    def _run(self, program: str, fn):
        """Run one program over the staged operands (`_Operands`): on the
        CPU call `fn` eagerly; on CUDA replay the program's captured graph,
        capturing it first if warm() did not. Returns `fn`'s outputs — on
        CUDA the graph's own output tensors, valid until the next replay of
        any program of this engine (they share one memory pool)."""
        if self.device.type != "cuda":
            return fn()
        entry = self._graphs.get(program)
        if entry is None:
            entry = self.capture(fn, program)
        entry[0].replay()
        self.graph_stats["replays"] += 1
        return entry[1]

    def capture(self, fn, program: str):
        """Run `fn` once eagerly on this engine's side stream (cuBLAS
        workspaces, kernel module loads: the run the graph then records),
        then capture it into a CUDA graph in this engine's own memory pool.
        Thread-local capture mode: a rolling swap captures the new version
        while the old version's scheduler thread keeps launching on the
        same card. A failure raises; there is no eager fallback."""
        t0 = time.perf_counter()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._side = torch.cuda.Stream(device=self.device)
        cur = torch.cuda.current_stream(self.device)
        side = self._side
        side.wait_stream(cur)           # the staged operands' copy
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            fn()
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                out = fn()
            except BaseException:
                # the capture is already broken: end it quietly and
                # surface the error that broke it
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            graph.capture_end()
        cur.wait_stream(side)           # replays follow the eager run
        self._graphs[program] = (graph, out)
        self.graph_stats["captures"] += 1
        self.graph_stats["capture_s"] += time.perf_counter() - t0
        self._pool_bytes = None
        return graph, out

    def graph_pool_bytes(self) -> int:
        """Bytes of the device segments in this engine's graph memory pool
        (0 on the CPU and once closed); measured once after each capture,
        from the allocator's snapshot."""
        if self._pool is None:
            return 0
        if self._pool_bytes is None:
            pool = tuple(self._pool)
            self._pool_bytes = sum(
                int(seg["total_size"]) for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", ())) == pool)
        return self._pool_bytes

    # ------------------------------------------------------ program ledger
    def _meter_program(self, program: str, warmup: bool):
        if program in self._programs:
            return
        self._programs.add(program)
        # a "compile" here is a program's first run (the first use of
        # its kernels and allocations), counted under the reference's name
        monitor.counter(
            "serving_decode_compiles_total",
            "First executions of a decode-runtime program per engine "
            "generation (each implies one XLA compile)",
            labels=("model", "program")).inc(model=self.name,
                                             program=program)
        if warmup:
            self.warmup_runs += 1
            monitor.counter(
                "serving_decode_warmup_runs_total",
                "AOT decode-runtime warmup executions (one per program per "
                "engine generation)", labels=("model",)).inc(model=self.name)
            return
        self.request_path_first_runs += 1
        log.warning(
            "decode[%s]: program %s first ran on the REQUEST path (its "
            "first-use costs hit a live stream) — warm() was skipped or "
            "the ladder changed", self.name, program)

    @torch.no_grad()
    def warm(self) -> float:
        """Run every prefill bucket, every chunk bucket, the COW copy, the
        KV-fabric page extract and land, the decode step (greedy and
        sampling) and, with speculation on, the draft's own programs and
        the propose (greedy and sampling) and verify programs once, so no
        live stream pays a first use. On CUDA each program but the COW copy
        and the page transfers is captured here (`capture`: an eager run on
        a side stream, then the capture) and replayed once. Returns the
        seconds it took."""
        with _device_scope(self.device):
            seconds = self._warm()
        # measured here, so describe() on the request path reads a number
        self.graph_pool_bytes()
        if self.draft is not None:
            self.draft.graph_pool_bytes()
        return seconds

    def _warm(self, decode: bool = True) -> float:
        """Warm (and on CUDA capture) this engine's programs; `decode`
        False leaves out the decode step, which a draft never runs."""
        t0 = time.perf_counter()
        dump_row = np.full((self.cache.pages_per_slot,), kvcache.DUMP_PAGE,
                           np.int64)
        # the prefill ladder, then the chunk ladder: suffix prefill after a
        # cache hit and budgeted chunks of a long prompt run through these
        for kind in ("prefill", "chunk"):
            for tb in self.prefill_buckets:
                self._meter_program(f"{kind}_{tb}", warmup=True)
                tok, _ = self._prompt(f"{kind}_{tb}",
                                      np.zeros((tb,), np.int64), 0, 1,
                                      dump_row, 0.0, 0, 0)
                int(tok)
        # the COW page copy (dump -> dump: page 0 is garbage by contract)
        self._meter_program("cow_copy", warmup=True)
        kvcache.copy_page(self._kpool, self._vpool, kvcache.DUMP_PAGE,
                          kvcache.DUMP_PAGE)
        # the KV-fabric page programs (spill demote/promote and the
        # disaggregated transfer): extract reads the dump page, land
        # writes it straight back through the staging ring
        self._meter_program("kv_extract", warmup=True)
        kx, vx = (t.cpu() for t in self._extract_fn(kvcache.DUMP_PAGE))
        self._meter_program("kv_land", warmup=True)
        self._land_fn(kvcache.DUMP_PAGE, kx, vx)
        s = self.cfg.slots
        zeros_i, no_slot = np.zeros((s,), np.int32), np.zeros((s,), bool)
        for sampling in (False, True) if decode else ():
            self._meter_program("decode_sampling" if sampling else "decode",
                                warmup=True)
            toks, _ = self._decode(zeros_i, no_slot,
                                   np.ones((s,), np.float32),
                                   np.full((s,), 5, np.int32), 0, sampling)
            toks.cpu()
        if self.draft is not None:
            # the draft warms its own programs, then the two speculative
            # ones: the k-token propose (draft's) and the k+1-position
            # verify (target's)
            d = self.draft
            d._warm(decode=False)
            k = int(self.cfg.spec_k)
            ds = d.cfg.slots
            for sampling in (False, True):
                d._meter_program(f"draft_{k}_sampling" if sampling
                                 else f"draft_{k}", warmup=True)
                drafted, _ = d._propose(
                    k, np.zeros((ds,), np.int32), np.zeros((ds,), bool),
                    np.ones((ds,), np.float32), np.full((ds,), 5, np.int32),
                    0, sampling)
                drafted.cpu()
            self._meter_program(f"verify_{k + 1}", warmup=True)
            vlog = self._verify(np.zeros((s,), np.int32), no_slot, drafted)
            vlog.cpu()
        seconds = time.perf_counter() - t0
        monitor.histogram(
            "serving_decode_warmup_seconds",
            "Full decode-runtime warmup duration (buckets + step)",
            labels=("model",),
            buckets=(0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120)).observe(
            seconds, model=self.name)
        return seconds

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
                with monitor.span("serving/kv_cow", model=self.name):
                    kvcache.copy_page(self._kpool, self._vpool,
                                      info.cow_src, info.cow_dst)
            except Exception:
                # a failed copy must not leak the slot or the pinned
                # source page — undo the admission before surfacing
                self.cache.release(info.slot)
                self.cache.unref_page(info.cow_src)
                raise
            self.cache.unref_page(info.cow_src)
        if self.draft is not None:
            self._admit_draft(info.slot, prompt)
        return info

    def _admit_draft(self, slot: int, prompt: np.ndarray):
        """Mirror a successful target admission into the draft's own
        pool. A dry draft pool never blocks the stream — it just decodes
        plain (speculation off, counted as a fallback)."""
        self._spec_on[slot] = True
        self._spec_hist[slot].clear()
        dinfo = None
        try:
            dinfo = self.draft.admit_prompt(np.asarray(prompt, np.int32))
        except Exception:   # noqa: BLE001 — draft trouble must never
            # take down an admission the target already accepted
            log.exception("decode[%s]: draft admission failed; stream "
                          "decodes plain", self.name)
        if dinfo is None:
            self.spec_disable(slot, "draft_admit")
        else:
            self._draft_slots[slot] = int(dinfo.slot)
            self._draft_origin[slot] = int(dinfo.cached_len)

    def spec_disable(self, slot: int, reason: str):
        """Turn speculation off for ONE stream (it plain-decodes to
        completion) and free its draft pages for the streams still
        speculating. Counted per reason: draft_admit / draft_prefill /
        draft_pages / acceptance_floor."""
        self._spec_on[slot] = False
        ds = self._draft_slots.get(slot)
        self._draft_slots[slot] = None
        if ds is not None and self.draft is not None:
            self.draft.cache.release(ds)
        fb = self.spec_stats["fallbacks"]
        fb[reason] = fb.get(reason, 0) + 1
        monitor.counter(
            "serving_decode_spec_fallbacks_total",
            "Streams whose speculation turned off (draft pool dry, "
            "draft prefill failure, or rolling acceptance under the "
            "floor)", labels=("model", "reason")).inc(
            model=self.name, reason=reason)

    def release_slot(self, slot: int):
        """Release a finished stream's target slot AND its draft mirror
        (the scheduler's call sites use this, never cache.release
        directly)."""
        self.cache.release(slot)
        if self.draft is not None:
            ds = self._draft_slots.pop(slot, None)
            self._draft_origin.pop(slot, None)
            if ds is not None:
                self.draft.cache.release(ds)
            self._spec_on[slot] = True
            self._spec_hist[slot].clear()

    def draft_prefill_origin(self, slot: int) -> Optional[int]:
        """Where the draft's prefill starts for this stream (its own
        cached-prefix length), or None when the stream speculates not."""
        if self.draft is None or self._draft_slots.get(slot) is None:
            return None
        return self._draft_origin.get(slot, 0)

    def draft_prefill(self, slot: int, prompt: np.ndarray, start: int,
                      n: int, temperature: float, top_k: int):
        """Advance the draft's prefill for `slot` by prompt positions
        [start, start+n) — the same dense-vs-chunk split as the target's
        path; the sampled token is discarded (the stream's first token
        comes from the TARGET's prefill)."""
        ds = self._draft_slots[slot]
        if start == 0 and n == len(prompt):
            self.draft.prefill(ds, prompt, temperature, top_k)
        else:
            self.draft.prefill_chunk(ds, prompt, start, n, temperature,
                                     top_k)

    def draft_prefill_done(self, slot: int, prompt: np.ndarray):
        """Draft prefill complete: index the draft's prompt pages so the
        NEXT admission of this prefix is a draft-side cache hit too."""
        ds = self._draft_slots.get(slot)
        if ds is not None:
            self.draft.cache.register_prefix(ds, prompt)

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
        with monitor.span("serving/prefill_chunk", model=self.name,
                          bucket=tb, tokens=n):
            tok, _ = self._prompt(f"chunk_{tb}", toks, start, start + n,
                                  self.cache.page_table[slot], temperature,
                                  top_k, self._counter)
        monitor.counter("serving_decode_prefills_total",
                        "Prefill program executions by bucket size "
                        "(chunk_* buckets are suffix/chunked prefills)",
                        labels=("model", "bucket")).inc(
            model=self.name, bucket=f"chunk_{tb}")
        tok = int(tok)
        self._last_tokens[slot] = tok
        return tok

    @torch.no_grad()
    def prefill(self, slot: int, prompt: np.ndarray, temperature: float,
                top_k: int) -> Tuple[int, torch.Tensor]:
        """Run the prompt through a bucket-padded prefill into `slot`'s
        pages; returns (first sampled token, last-position logits (V,) on
        the device). On CUDA the logits are the captured graph's output:
        valid until this engine's next program run (clone to keep them)."""
        n = int(len(prompt))
        tb = self.bucket_for(n)
        toks = np.zeros((tb,), np.int64)
        toks[:n] = prompt
        self._check_ids(toks[:n])
        self._temps[slot] = temperature
        self._topks[slot] = top_k
        self._counter += 1
        self._meter_program(f"prefill_{tb}", warmup=False)
        with monitor.span("serving/prefill", model=self.name, bucket=tb):
            tok, logits = self._prompt(f"prefill_{tb}", toks, 0, n,
                                       self.cache.page_table[slot],
                                       temperature, top_k, self._counter)
        monitor.counter("serving_decode_prefills_total",
                        "Prefill program executions by bucket size "
                        "(chunk_* buckets are suffix/chunked prefills)",
                        labels=("model", "bucket")).inc(
            model=self.name, bucket=str(tb))
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
        synchronisation. On CUDA the logits are the captured graph's
        output: valid until this engine's next program run (clone to keep
        them); the scheduler never reads them."""
        act = np.zeros((self.cfg.slots,), bool)
        excl = frozenset(int(s) for s in exclude)
        n_runnable = 0
        for s in self.cache.active_slots():
            if s in excl:
                continue                # prefill still in flight
            if self.cache.ensure_page(s):
                act[s] = True
                n_runnable += 1
        self._counter += 1
        sampling = bool((self._temps[act] > 0).any())
        self._meter_program("decode_sampling" if sampling else "decode",
                            warmup=False)
        with monitor.span("serving/decode_step", model=self.name,
                          active=n_runnable):
            toks, logits = self._decode(self._last_tokens, act, self._temps,
                                        self._topks, self._counter,
                                        sampling)
            toks_np = toks.cpu().numpy().astype(np.int32)
        for s in np.nonzero(act)[0]:
            self.cache.advance(int(s))
            self._last_tokens[s] = toks_np[s]
        self.steps += 1
        monitor.counter("serving_decode_steps_total",
                        "Compiled decode iterations executed",
                        labels=("model",)).inc(model=self.name)
        return toks_np, act, logits

    # ------------------------------------------------- speculative decoding
    def _spec_dist(self, logits, temp: float, topk: int) -> np.ndarray:
        """The sampling distribution `_sample` draws from, recomputed on
        the host (float64): top-k filtering with the SAME clip against
        TOP_K_MAX, then temperature softmax. Rejection sampling is only
        exact when this q/p matches the device sampler's distribution
        term for term."""
        lg = np.asarray(logits, np.float64)
        v = lg.shape[-1]
        if topk > 0:
            kk = min(max(int(topk), 1), min(TOP_K_MAX, v))
            kth = np.sort(lg)[-kk]
            lg = np.where(lg >= kth, lg, -np.inf)
        z = lg / max(float(temp), 1e-30)
        z = z - z.max()
        p = np.exp(z)
        return p / p.sum()

    def _spec_accept(self, drafted, vlog, qlog, temp: float, topk: int
                     ) -> Tuple[int, int]:
        """Accept/reject one stream's k draft proposals against the
        target's k+1 verify logits. Returns (accepted count a, the one
        extra token): greedy is exact prefix match on argmax with the
        target's own argmax at the first mismatch (bitwise the plain
        stream); temperature is true rejection sampling — accept d_i with
        prob min(1, p(d_i)/q(d_i)), resample the first rejection from the
        residual max(p - q, 0), and on full acceptance sample the bonus
        token from the target's (k+1)-th distribution."""
        k = len(drafted)
        if temp <= 0:
            a = 0
            for i in range(k):
                if int(np.argmax(vlog[i])) == int(drafted[i]):
                    a += 1
                else:
                    break
            return a, int(np.argmax(vlog[a]))
        for i in range(k):
            d = int(drafted[i])
            p = self._spec_dist(vlog[i], temp, topk)
            q = self._spec_dist(qlog[i], temp, topk)
            if q[d] > 0.0 and self._spec_rng.random_sample() \
                    < min(1.0, float(p[d]) / float(q[d])):
                continue
            res = np.maximum(p - q, 0.0)
            tot = float(res.sum())
            if tot <= 0.0:
                res, tot = p, float(p.sum())    # p == q: any sample of
                # p is already correctly distributed
            return i, int(self._spec_rng.choice(len(res), p=res / tot))
        p = self._spec_dist(vlog[k], temp, topk)
        return k, int(self._spec_rng.choice(len(p), p=p / p.sum()))

    @torch.no_grad()
    def spec_step(self, exclude=()) -> Dict[int, dict]:
        """One speculative round over every eligible stream: the draft
        proposes k tokens for all of them, the target scores all k+1
        positions from the proposals on the device, and ONE copy brings
        drafted tokens, draft logits and verify logits to the host, which
        accepts per slot. Both caches advance by accepted+1 (the draft's
        propose already consumed its own k-th sample, so whatever prefix
        survives, the next round resumes from exactly one new token).

        Returns {slot: {"tokens": [...], "proposed": k, "accepted": a}}
        for every slot handled this round — the scheduler emits those
        bursts and excludes the slots from the plain step. Slots under
        page/context pressure are left for the plain path this round; a
        dry DRAFT pool or a collapsed acceptance window turns speculation
        off for that stream (`spec_disable`)."""
        if self.draft is None:
            return {}
        k = int(self.cfg.spec_k)
        excl = frozenset(int(s) for s in exclude)
        pairs = []
        for s in self.cache.active_slots():
            if s in excl or not self._spec_on[s]:
                continue
            ds = self._draft_slots.get(s)
            if ds is None:
                continue
            if not self.cache.ensure_capacity(s, k + 1):
                # target page stall or context cap: the plain step's
                # per-token path copes (and finishes length_cap streams)
                continue
            if not self.draft.cache.ensure_capacity(ds, k + 1):
                self.spec_disable(s, "draft_pages")
                continue
            pairs.append((s, ds))
        if not pairs:
            return {}
        d = self.draft
        dact = np.zeros((d.cfg.slots,), bool)
        dtok = d._last_tokens.copy()
        tact = np.zeros((self.cfg.slots,), bool)
        rows = np.zeros((self.cfg.slots,), np.int64)
        for s, ds in pairs:
            dact[ds] = tact[s] = True
            rows[s] = ds
            # the draft extends the TARGET's stream: it consumes the
            # target's last sampled token, not its own prefill sample
            dtok[ds] = self._last_tokens[s]
        d._counter += k
        sampling = bool((d._temps[dact] > 0).any())
        d._meter_program(f"draft_{k}_sampling" if sampling
                         else f"draft_{k}", warmup=False)
        with monitor.span("serving/spec_draft", model=self.name,
                          active=len(pairs), k=k):
            drafted, qlog = d._propose(k, dtok, dact, d._temps, d._topks,
                                       d._counter - k + 1, sampling)
        self._meter_program(f"verify_{k + 1}", warmup=False)
        with monitor.span("serving/spec_verify", model=self.name,
                          active=len(pairs)):
            vlog = self._verify(self._last_tokens, tact, drafted, rows)
        # the round's one synchronisation: drafted tokens (exact in f32
        # below 2^24), draft logits and verify logits in one copy back
        sd, v = d.cfg.slots, vlog.shape[-1]
        host = torch.cat([drafted.to(torch.float32).reshape(-1),
                          qlog.to(torch.float32).reshape(-1),
                          vlog.to(torch.float32).reshape(-1)]).cpu().numpy()
        self.spec_stats["host_syncs"] += 1
        n_d, n_q = sd * k, sd * k * v
        drafted = host[:n_d].reshape(sd, k).astype(np.int64)
        qlog = host[n_d:n_d + n_q].reshape(sd, k, v)
        vlog = host[n_d + n_q:].reshape(self.cfg.slots, k + 1, v)
        out: Dict[int, dict] = {}
        n_prop = n_acc = 0
        ratio = monitor.histogram(
            "serving_decode_spec_acceptance_ratio",
            "Per-stream-per-round fraction of draft proposals the "
            "verifier accepted (accepted / k)", labels=("model",),
            buckets=(0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875,
                     1.0))
        floor = float(self.cfg.spec_accept_floor)
        for s, ds in pairs:
            a, extra = self._spec_accept(
                drafted[ds], vlog[s], qlog[ds], float(self._temps[s]),
                int(self._topks[s]))
            n_prop += k
            n_acc += a
            ratio.observe(a / k, model=self.name)
            for _ in range(a + 1):
                self.cache.advance(s)
                d.cache.advance(ds)
            self._last_tokens[s] = extra
            d._last_tokens[ds] = extra
            self.spec_stats["proposed"] += k
            self.spec_stats["accepted"] += a
            out[s] = {"tokens": [int(t) for t in drafted[ds][:a]]
                      + [int(extra)],
                      "proposed": k, "accepted": a}
            hist = self._spec_hist[s]
            hist.append((k, a))
            if len(hist) == hist.maxlen:
                pw = sum(p for p, _ in hist)
                aw = sum(acc for _, acc in hist)
                if pw > 0 and aw / pw < floor:
                    self.spec_disable(s, "acceptance_floor")
                    out[s]["fallback"] = "acceptance_floor"
        self.spec_stats["rounds"] += 1
        monitor.counter(
            "serving_decode_spec_proposed_total",
            "Draft tokens proposed to the verifier",
            labels=("model",)).inc(n_prop, model=self.name)
        monitor.counter(
            "serving_decode_spec_accepted_total",
            "Draft tokens the verifier accepted (the speedup is "
            "accepted + rounds extra tokens for 2 dispatches per round)",
            labels=("model",)).inc(n_acc, model=self.name)
        monitor.counter(
            "serving_decode_spec_rounds_total",
            "Speculative draft+verify rounds executed (2 dispatches "
            "each, emitting accepted+1 tokens per handled stream)",
            labels=("model",)).inc(model=self.name)
        return out

    @torch.no_grad()
    def logits_full(self, tokens) -> np.ndarray:
        """(B, T) -> (B, T, V) float32 logits by full-sequence recompute
        (the parity oracle and the quantization-quality probe)."""
        tokens = np.asarray(tokens, np.int64)
        self._check_ids(tokens)
        out = self._logits_fn(torch.from_numpy(tokens).to(self.device))
        return out.to(torch.float32).cpu().numpy()

    def close(self):
        """Release the page pools, the captured graphs and their memory
        pool, the spill slab and the draft (the engine is retired)."""
        self._closed = True
        self._graphs = {}
        self._pool = self._side = None
        self._pool_bytes = 0
        self._kpool = self._vpool = None
        self._params = None
        self._stage = []
        if self.spill is not None:
            self.spill.close()
        if self.draft is not None:
            self.draft.close()

    def describe_graphs(self) -> dict:
        """The captured programs (none on the CPU), their memory pool's
        bytes, and captures / capture seconds / replays so far."""
        return dict(self.graph_stats, programs=sorted(self._graphs),
                    pool_bytes=self.graph_pool_bytes())

    def describe(self) -> dict:
        d = self.cache.describe()
        d.update({"prefill_buckets": list(self.prefill_buckets),
                  "quantize": self.cfg.quantize,
                  "vocab_size": self.vocab,
                  "n_layers": self.n_layers,
                  "prefill_chunk_tokens": self.prefill_chunk_tokens,
                  "device": str(self.device),
                  "steps": self.steps,
                  "request_path_first_runs": self.request_path_first_runs,
                  "fabric": dict(self.fabric),
                  "graphs": self.describe_graphs()})
        if self.draft is not None:
            d["spec"] = {"draft": self.cfg.spec_draft,
                         "k": int(self.cfg.spec_k),
                         "accept_floor": float(self.cfg.spec_accept_floor),
                         "window": int(self.cfg.spec_window),
                         "stats": {k: (dict(v) if isinstance(v, dict)
                                       else v)
                                   for k, v in self.spec_stats.items()},
                         "draft_pool": self.draft.cache.describe(),
                         "draft_graphs": self.draft.describe_graphs()}
        return d


# ==========================================================================
# The scheduler: iteration-level admission over one or more engines
# ==========================================================================
class _PrefillJob:
    """Admission-to-first-token state for one slot: the uncached suffix
    [pos, len(prompt)) still to prefill, run in budgeted chunks between
    decode steps."""

    __slots__ = ("req", "pos", "chunks", "dpos", "tok")

    def __init__(self, req: GenerateRequest, pos: int,
                 dpos: Optional[int] = None):
        self.req = req
        self.pos = pos
        self.chunks = 0
        #: the speculative draft mirror's prefill cursor (None: the stream
        #: has no draft slot); the job completes only when BOTH caches
        #: cover the prompt
        self.dpos = dpos
        #: the target's sampled first token, held until the draft mirror
        #: catches up
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
        self._plock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.decode.DecodeScheduler._plock")
        self._runs: List[_EngineRun] = []
        self._rlock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.decode.DecodeScheduler._rlock")
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._draining = False
        #: KV-fabric jobs (page export/import) marshalled onto the
        #: scheduler thread — the ONLY thread that drives the device
        #: pools. Guarded by _plock; (fn, done, box)
        self._fabric: deque = deque()
        self.stats = {"preempted_joins": 0, "rejected_queue_full": 0,
                      "rejected_deadline": 0}
        # goodput accounting: page-stall slot-seconds apportioned out of
        # the step window by _step_all (stalled/considered share of each
        # step's wall) — read by the loop, only meaningful under the
        # ledger
        self._stall_s = 0.0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"DecodeScheduler-{name}")
        self._started = False

    # -------------------------------------------------------------- control
    def install(self, engine: DecodeEngine, version: int):
        """Make `engine` the admitting engine; older runs stop admitting
        and retire once their in-flight sequences finish. An engine that
        is still draining here (a rollback to a resident version) admits
        again in its own run: one run per engine, so no slot is stepped
        twice."""
        with self._rlock:
            for run in self._runs:
                run.admitting = False
            run = next((r for r in self._runs if r.engine is engine), None)
            if run is None:
                run = _EngineRun(engine, version)
            else:
                self._runs.remove(run)
                run.version = version
                run.admitting = True
            self._runs.append(run)
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
                monitor.counter("serving_decode_rejected_total",
                                "Generation requests rejected by "
                                "admission control",
                                labels=("model", "reason")).inc(
                    model=self.name, reason="queue_full")
                raise ServerOverloadedError(
                    f"decode[{self.name}]: join queue full "
                    f"({self.queue_limit} pending)")
            self._pending.append(req)
            depth = len(self._pending)
        monitor.gauge("serving_decode_queue_depth",
                      "Generation requests waiting for a decode slot",
                      labels=("model",)).set(depth, model=self.name)
        flight.note(req.ctx, "queued", depth=depth, model=self.name)
        self._wake.set()

    def run_fabric(self, fn, timeout: float = 30.0):
        """Run ``fn(engine)`` on the scheduler thread against the
        admitting engine and return its result. Any HTTP-thread work that
        reads or writes the device pools (page export for a
        disaggregated transfer, shipment import) marshals through here:
        the job runs between ticks, never concurrently with a step.
        Raises the job's own exception, or DeadlineExceededError if the
        loop never got to it within `timeout`."""
        if self._stop.is_set() or self._draining:
            raise ServerDrainingError(
                f"decode[{self.name}] is shutting down")
        box: dict = {}
        done = threading.Event()
        with self._plock:
            self._fabric.append((fn, done, box))
        self._wake.set()
        if not done.wait(timeout):
            raise DeadlineExceededError(
                f"decode[{self.name}]: fabric job did not run within "
                f"{timeout}s (scheduler saturated or stopped)")
        if "exc" in box:
            raise box["exc"]
        return box.get("res")

    def _fabric_tick(self) -> bool:
        """Drain queued fabric jobs on the scheduler thread. A job's
        failure belongs to its submitting thread (delivered through the
        box), never to the loop."""
        if not self._fabric:
            # unlocked empty check on the common path: deque reads are
            # atomic under the GIL, and a racing submit sets _wake — the
            # NEXT pass drains it
            return False
        worked = False
        while True:
            with self._plock:
                if not self._fabric:
                    return worked
                fn, done, box = self._fabric.popleft()
            with self._rlock:
                engine = self._runs[-1].engine \
                    if self._runs and self._runs[-1].admitting else None
            try:
                if engine is None:
                    raise ServerDrainingError(
                        f"decode[{self.name}]: no admitting engine for "
                        "fabric job")
                box["res"] = fn(engine)
            except Exception as e:  # noqa: BLE001 — surfaced to the
                # submitting thread via the box; the scheduler loop must
                # outlive any single job's corrupt shipment
                box["exc"] = e
            done.set()
            worked = True

    def _fail_fabric(self, exc: Exception):
        while True:
            with self._plock:
                if not self._fabric:
                    return
                _fn, done, box = self._fabric.popleft()
            box["exc"] = exc
            done.set()

    def release_engine(self, engine: DecodeEngine):
        """The servable no longer keeps `engine` resident: close it now
        if no run drives it, else let `_retire` close it once drained."""
        with self._rlock:
            engine.resident = False
            if not any(r.engine is engine for r in self._runs):
                engine.close()

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
        try:
            with self._rlock:
                device = self._runs[-1].engine.device
            with _device_scope(device):
                crash = self._loop_on_device()
        except Exception as e:      # noqa: BLE001 — the device read or
            # its scope failed: tear down as a crash inside the loop does
            # (every stream failed, _stop set)
            crash = e
            log.exception("decode[%s]: scheduler crashed; failing "
                          "all streams", self.name)
            self._stop.set()
        self._teardown(crash)

    def _loop_on_device(self) -> Optional[Exception]:
        """The scheduler passes; returns the exception that crashed
        them, or None when `_stop` ended them."""
        from deeplearning4j_tpu_torch.monitor import goodput
        crash: Optional[Exception] = None
        while not self._stop.is_set():
            # goodput split of the scheduler pass: admission vs the
            # compute window (prefill + step + retire) with the step's
            # page-stall share apportioned out, vs idle wait below.
            # Zero-cost while the ledger is off: one flag check per pass
            gp = goodput.goodput_enabled()
            t_pass = time.perf_counter() if gp else 0.0
            try:
                worked = self._admit()
                worked = self._fabric_tick() or worked
                t_admitted = time.perf_counter() if gp else 0.0
                stall0 = self._stall_s
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
            if gp:
                t_end = time.perf_counter()
                stall = max(self._stall_s - stall0, 0.0)
                goodput.decode_note(self.name, "admission",
                                    t_admitted - t_pass)
                goodput.decode_note(self.name, "page_stall", stall)
                goodput.decode_note(
                    self.name, "step_compute",
                    max(t_end - t_admitted - stall, 0.0))
            if not worked:
                idle0 = time.perf_counter() if gp else 0.0
                self._wake.wait(0.005)
                self._wake.clear()
                if gp:
                    goodput.decode_note(self.name, "idle",
                                        time.perf_counter() - idle0)
        return crash

    def _teardown(self, crash: Optional[Exception]):
        """Everything still live gets a terminal error: `crash`, or a
        draining error when the loop was stopped."""
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
        self._fail_fabric(exc)

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
                monitor.counter("serving_decode_rejected_total",
                                "Generation requests rejected by "
                                "admission control",
                                labels=("model", "reason")).inc(
                    model=self.name, reason="deadline")
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
            if flight.enabled():
                # admission wait + the engine generation whose params
                # will write this stream's KV + how much prefill the
                # prefix cache just made free
                flight.note(req.ctx, "admitted", slot=info.slot,
                            engine_version=run.version,
                            wait_ms=round(
                                (time.monotonic() - req.enqueued) * 1e3,
                                3),
                            joined_running=joined_running,
                            cached_tokens=int(info.cached_len),
                            cow=info.cow_src is not None,
                            model=self.name)
            req.version = run.version
            run.prefill[info.slot] = _PrefillJob(
                req, int(info.cached_len),
                run.engine.draft_prefill_origin(info.slot))
            if joined_running:
                self.stats["preempted_joins"] += 1
                monitor.counter(
                    "serving_decode_preempted_joins_total",
                    "Requests admitted into an already-running batch "
                    "between token steps (continuous batching)",
                    labels=("model",)).inc(model=self.name)
            worked = True
        with self._plock:
            depth = len(self._pending)
        monitor.gauge("serving_decode_queue_depth",
                      "Generation requests waiting for a decode slot",
                      labels=("model",)).set(depth, model=self.name)
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
                    with monitor.bind_context(req.ctx):
                        while job.pos < total:
                            if budget > 0 and spent >= budget:
                                break
                            n = total - job.pos if budget <= 0 \
                                else min(total - job.pos, budget - spent)
                            if job.pos == 0 and n == total:
                                # cold, whole prompt within budget: the
                                # dense program (also what cache-off runs)
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
                # the speculative draft mirror prefills under the same
                # per-tick budget; its failure never fails the stream —
                # speculation just turns off and the stream decodes plain
                try:
                    while job.dpos is not None and job.dpos < total:
                        if budget > 0 and spent >= budget:
                            break
                        n = total - job.dpos if budget <= 0 \
                            else min(total - job.dpos, budget - spent)
                        run.engine.draft_prefill(
                            slot, req.prompt, job.dpos, n,
                            req.temperature, req.top_k)
                        job.dpos += n
                        spent += n
                        worked = True
                except Exception:  # noqa: BLE001 — the draft is optional
                    log.exception("decode[%s]: draft prefill failed; "
                                  "stream decodes plain", self.name)
                    run.engine.spec_disable(slot, "draft_prefill")
                    job.dpos = None
                if job.pos >= total and (job.dpos is None
                                         or job.dpos >= total):
                    run.prefill.pop(slot, None)
                    req.prefill_chunks = job.chunks
                    # prefill complete: every mapped prompt page holds
                    # final K/V — only now may the prefix index share it
                    run.engine.cache.register_prefix(slot, req.prompt)
                    run.engine.draft_prefill_done(slot, req.prompt)
                    run.slot_req[slot] = req
                    monitor.histogram(
                        "serving_decode_prefill_chunks",
                        "Prefill program executions per admission "
                        "(1 = unchunked; higher = budgeted chunking "
                        "interleaved with decode steps)",
                        labels=("model",),
                        buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
                    ).observe(job.chunks, model=self.name)
                    flight.note(req.ctx, "prefill_done",
                                chunks=job.chunks,
                                cached_tokens=req.cached_tokens,
                                model=self.name)
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
        exemplar = None if req.ctx is None else req.ctx.trace_id
        if req.last_emit_at is not None:
            if monitor.tracing_enabled() and req._last_pc is not None:
                # the gap as a span on the scheduler track, under the
                # stream's trace_id
                monitor.add_span("decode/itl_gap", req._last_pc,
                                 time.perf_counter(), ctx=req.ctx,
                                 model=self.name, index=req.n_emitted)
            monitor.histogram(
                "serving_decode_inter_token_seconds",
                "Gap between consecutive streamed tokens of one request",
                labels=("model",), buckets=_ITL_BUCKETS).observe(
                time.monotonic() - req.last_emit_at, model=self.name,
                exemplar=exemplar)
        elif req.n_emitted == 0:
            monitor.histogram(
                "serving_decode_ttft_seconds",
                "Time from request arrival to its first generated token",
                labels=("model",), buckets=_TTFT_BUCKETS).observe(
                time.monotonic() - req.enqueued, model=self.name,
                exemplar=exemplar)
        req.emit(tok)
        monitor.counter("serving_decode_tokens_total",
                        "Generated tokens streamed to clients",
                        labels=("model",)).inc(model=self.name)
        if req.n_emitted >= req.max_new_tokens:
            self._finish(run, slot, req, "length")

    def _finish(self, run: _EngineRun, slot: int, req: GenerateRequest,
                reason: str):
        run.engine.release_slot(slot)
        run.slot_req.pop(slot, None)
        req.finish(reason)
        if monitor.tracing_enabled():
            # the whole stream as one span under its trace_id — queue
            # wait + prefill + every token
            monitor.add_span("serving/stream", req.t0_pc,
                             time.perf_counter(), ctx=req.ctx,
                             model=self.name, reason=reason,
                             tokens=req.n_emitted,
                             engine_version=run.version)
        flight.note(req.ctx, "finish", reason=reason,
                    tokens=req.n_emitted,
                    spec_proposed=req.spec_proposed,
                    spec_accepted=req.spec_accepted, model=self.name)
        monitor.counter("serving_decode_finished_total",
                        "Finished generations by reason",
                        labels=("model", "reason")).inc(
            model=self.name, reason=reason)

    def _step_all(self) -> bool:
        from deeplearning4j_tpu_torch.monitor import goodput
        gp = goodput.goodput_enabled()
        with self._rlock:
            runs = [r for r in self._runs if r.slot_req]
        worked = False
        for run in runs:
            # speculation first: eligible streams get an accepted burst
            # (draft propose + target verify for up to k+1 tokens each);
            # everything speculation did not handle falls through to the
            # plain one-token step below
            spec = run.engine.spec_step(exclude=run.prefill.keys()) \
                if run.engine.spec_enabled else {}
            for slot, res in spec.items():
                req = run.slot_req.get(slot)
                if req is None:
                    continue
                req.spec_rounds += 1
                req.spec_proposed += res["proposed"]
                req.spec_accepted += res["accepted"]
                if res.get("fallback") and flight.enabled():
                    flight.note(req.ctx, "spec_fallback",
                                reason=res["fallback"], slot=slot,
                                proposed=req.spec_proposed,
                                accepted=req.spec_accepted,
                                model=self.name)
                for tok in res["tokens"]:
                    self._emit(run, slot, req, tok)
                    if req.done.is_set():
                        break
            if spec:
                worked = True
            handled = set(spec)
            if not any(s not in handled for s in run.slot_req):
                continue
            step_t0 = time.perf_counter() if gp else 0.0
            toks, act, _ = run.engine.step(
                exclude=set(run.prefill.keys()) | handled)
            considered = stalled = 0
            for slot, req in list(run.slot_req.items()):
                if slot in handled:
                    continue
                considered += 1
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
                else:
                    # page-stalled this step (counted by the cache)
                    stalled += 1
                    if flight.enabled():
                        flight.note(req.ctx, "page_stall", slot=slot,
                                    seq_len=int(
                                        run.engine.cache.seq_lens[slot]),
                                    model=self.name)
            if gp and considered:
                self._stall_s += (time.perf_counter() - step_t0) \
                    * (stalled / considered)
            worked = True
        return worked

    def _retire(self):
        with self._rlock:
            keep = []
            for run in self._runs:
                if not run.admitting and not run.slot_req \
                        and not run.prefill:
                    if not run.engine.resident:
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
# The servable: versions + engine lifecycle behind the registry surface
# ==========================================================================
class ServedLM:
    """One named decode servable: version history, engines and their
    scheduler.

    The LM sibling of registry.ServedModel (status / describe / swap /
    rollback / shutdown), so the registry and the HTTP server drive both
    kinds alike. Every engine runs on the device of the network it was
    built from."""

    kind = "lm"

    def __init__(self, name: str, model, source: str,
                 decode: Optional[DecodeConfig] = None):
        self.name = name
        self.cfg = decode if decode is not None else DecodeConfig()
        self.status = "loading"
        # _swap_lock serializes whole swap/rollback operations (the warm
        # included); _state_lock guards only brief mutations of versions/
        # active, so describe() never blocks behind a warming swap
        self._swap_lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.decode.ServedLM._swap_lock")
        self._state_lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.decode.ServedLM._state_lock")
        engine = DecodeEngine(model, self.cfg, name=name)
        self.warmup_seconds = engine.warm()
        self.vocab = engine.vocab
        self.max_context = engine.max_context
        self.scheduler = DecodeScheduler(name,
                                         queue_limit=self.cfg.queue_limit)
        engine.resident = True
        self.scheduler.install(engine, version=1)
        self.versions: List[ServableVersion] = [
            ServableVersion(1, str(source), model)]
        self.active = 0
        #: request-path snapshot of the active version's metadata
        self.active_info = self.versions[0].describe()
        #: version -> its engine, kept resident (open) while the version
        #: is in `versions`
        self._engines: Dict[int, DecodeEngine] = {1: engine}
        #: seconds of the last swap/rollback (build + warm + install)
        self.last_swap_seconds: Optional[float] = None
        self.status = "ready"
        monitor.gauge("serving_model_ready",
                      "1 while the servable is warmed and live",
                      labels=("model",)).set(1, model=name)

    @property
    def model(self):
        """The active version's network."""
        return self.versions[self.active].model

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

    # ------------------------------------------------------------ kv fabric
    def export_prefix(self, prompt, timeout: float = 30.0) -> bytes:
        """Serialize the KV pages covering `prompt`'s full blocks into a
        framed transfer blob (the prefill half of disaggregation). If the
        prefix isn't cached yet, a one-token greedy generation prefills
        and retains it first; the page reads run on the scheduler thread
        via run_fabric."""
        if self.status == "stopping":
            raise ServerDrainingError(f"decode[{self.name}] is draining")
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        engine = self.scheduler.admitting_engine()
        if engine is None:
            raise ServerDrainingError(
                f"decode[{self.name}]: no admitting engine")
        if not engine.cfg.prefix_cache:
            raise ValueError(
                f"decode[{self.name}]: prefix cache disabled; nothing "
                "to export")
        ps = engine.cfg.page_size
        full = (int(prompt.size) // ps) * ps
        if full < ps:
            raise ValueError(
                f"prompt too short to export: {prompt.size} tokens "
                f"< one {ps}-token page")
        head = prompt[:full]
        if engine.cache.cached_prefix_len(head) < full:
            req = self.generate(head, max_new_tokens=1, temperature=0.0,
                                deadline=timeout)
            while True:
                kind, payload = req.events.get(timeout=timeout)
                if kind == "done":
                    break
                if kind == "error":
                    raise payload
        frames = self.scheduler.run_fabric(
            lambda eng: eng.export_pages(head), timeout=timeout)
        return kvfabric.pack_transfer(np.asarray(head, np.int32), frames,
                                      ps)

    def import_prefix(self, payload: bytes, timeout: float = 30.0) -> dict:
        """Land a framed page transfer (produced by a prefill server's
        export_prefix) into this servable's prefix cache. Frame integrity
        and geometry are verified before any pool write; a bad shipment
        raises kvfabric.FrameError and leaves the cache untouched."""
        if self.status == "stopping":
            raise ServerDrainingError(f"decode[{self.name}] is draining")
        tokens, frames, hdr = kvfabric.unpack_transfer(payload)
        engine = self.scheduler.admitting_engine()
        if engine is None:
            raise ServerDrainingError(
                f"decode[{self.name}]: no admitting engine")
        try:
            page_size = int(hdr["page_size"])
        except (KeyError, TypeError, ValueError):
            raise kvfabric.FrameError(
                "transfer header carries no page_size") from None
        if page_size != int(engine.cfg.page_size):
            raise kvfabric.FrameError(
                f"transfer page_size {page_size} != "
                f"{engine.cfg.page_size} on decode[{self.name}]")
        if not engine.cfg.prefix_cache:
            raise ValueError(
                f"decode[{self.name}]: prefix cache disabled; cannot "
                "adopt pages")
        if tokens.size and (tokens.min() < 0 or tokens.max() >= self.vocab):
            raise kvfabric.FrameError(
                f"transfer tokens outside [0, {self.vocab})")
        adopted = self.scheduler.run_fabric(
            lambda eng: eng.import_pages(tokens, frames), timeout=timeout)
        return {"adopted": int(adopted), "pages": len(frames),
                "tokens": int(np.asarray(tokens).size)}

    # ------------------------------------------------------------ lifecycle
    def _activate(self, sv: ServableVersion, variant: Optional[str]):
        """Roll admissions onto version `sv`: its resident engine when it
        still has one (a warm rollback), else a full replacement engine
        built and warmed off the request path. In-flight sequences finish
        on their own engine (KV pages are only meaningful under the
        weights that wrote them). `variant` is the source's parsed ``@``
        suffix; None keeps the servable's config as deployed."""
        t0 = time.perf_counter()
        engine = self._engines.get(sv.version)
        if engine is None or engine._closed:
            cfg = apply_variant(self.cfg, variant) \
                if variant is not None else self.cfg
            engine = DecodeEngine(sv.model, cfg, name=self.name)
            if engine.vocab != self.vocab:
                engine.close()
                raise ModelLoadError(
                    f"swap rejected: {sv.source!r} has vocab "
                    f"{engine.vocab}, live servable {self.name!r} serves "
                    f"{self.vocab} (deploy under a new name)")
            try:
                with monitor.span("serving/swap", model=self.name,
                                  version=sv.version):
                    self.warmup_seconds = engine.warm()
            except Exception:
                engine.close()
                raise
            engine.resident = True
            self._engines[sv.version] = engine
        self.scheduler.install(engine, version=sv.version)
        if engine.max_context != self.max_context:
            # a swap may change KV capacity (cfg.max_context None derives
            # it from the model); generate() validates against the LIVE
            # admitting engine, and the scheduler re-checks at admission
            # for requests that raced this update
            log.warning("decode[%s]: max_context %d -> %d across swap",
                        self.name, self.max_context, engine.max_context)
            self.max_context = engine.max_context
        self.last_swap_seconds = time.perf_counter() - t0
        monitor.histogram("serving_swap_seconds",
                          "Load+warm+swap duration (off the request path)",
                          labels=("model",),
                          buckets=(0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120)
                          ).observe(self.last_swap_seconds, model=self.name)

    def swap(self, source, keep_versions: int = 3) -> dict:
        """Load `source`, warm a replacement engine off the request path,
        and make it the admitting version; streams already running finish
        on their own engine."""
        base, variant = (source, None) if not isinstance(source, str) \
            else parse_variant(source)
        with self._swap_lock:
            if self.status == "stopping":
                raise ServerDrainingError(
                    f"decode[{self.name}] is draining; swap rejected")
            model = load_servable(base, device=self.model.device)
            with self._state_lock:
                next_version = self.versions[-1].version + 1
            sv = ServableVersion(next_version, str(source), model)
            self._activate(sv, variant)
            with self._state_lock:
                self.versions.append(sv)
                self.active = len(self.versions) - 1
                dropped = []
                while len(self.versions) > keep_versions:
                    dropped.append(self.versions.pop(0))
                    self.active -= 1
                self.active_info = sv.describe()
            for old in dropped:
                engine = self._engines.pop(old.version, None)
                if engine is not None:
                    self.scheduler.release_engine(engine)
                log.info("decode[%s]: retired v%d (%s) from memory",
                         self.name, old.version, old.source)
            monitor.counter("serving_swaps_total",
                            "Zero-downtime model hot-swaps",
                            labels=("model",)).inc(model=self.name)
        log.info("decode[%s]: now admitting on v%d (%s); older versions "
                 "drain in place", self.name, sv.version, sv.source)
        return sv.describe()

    def rollback(self) -> dict:
        """One-step rollback: admissions go back to the version before
        the active one, on its resident (warm) engine."""
        with self._swap_lock:
            if self.status == "stopping":
                raise ServerDrainingError(
                    f"decode[{self.name}] is draining; rollback rejected")
            with self._state_lock:
                if self.active == 0:
                    raise ModelLoadError(
                        f"decode[{self.name}]: no previous version in "
                        "memory to roll back to")
                sv = self.versions[self.active - 1]
            variant = parse_variant(sv.source)[1] \
                if isinstance(sv.source, str) else None
            self._activate(sv, variant)
            with self._state_lock:
                self.active -= 1
                self.active_info = sv.describe()
            monitor.counter("serving_rollbacks_total",
                            "One-step version rollbacks",
                            labels=("model",)).inc(model=self.name)
        log.warning("decode[%s]: rolled back to v%d (%s)", self.name,
                    sv.version, sv.source)
        return sv.describe()

    # --------------------------------------------------------------- admin
    def queue_state(self) -> Tuple[int, int]:
        """(depth, limit) of the join queue — the Retry-After input."""
        return self.scheduler.queue_state()

    def describe(self) -> dict:
        with self._state_lock:
            newest = self.scheduler.admitting_engine()
            d = {
                "name": self.name,
                "kind": self.kind,
                "status": self.status,
                "vocab_size": self.vocab,
                "max_context": self.max_context,
                "active_version": self.versions[self.active].version,
                "versions": [v.describe() for v in self.versions],
                "resident_engines": sorted(self._engines),
                "pending": self.scheduler.queue_state()[0],
                "inflight": self.scheduler.inflight(),
            }
            if newest is not None:
                d["decode"] = newest.describe()
            return d

    def shutdown(self, drain: bool = True, timeout: float = 30.0):
        self.status = "stopping"
        monitor.gauge("serving_model_ready",
                      "1 while the servable is warmed and live",
                      labels=("model",)).set(0, model=self.name)
        self.scheduler.drain(timeout=timeout if drain else 0.1)
        for engine in list(self._engines.values()):
            self.scheduler.release_engine(engine)
