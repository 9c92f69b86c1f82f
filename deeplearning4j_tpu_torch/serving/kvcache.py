"""Paged KV cache — fixed-shape attention memory for continuous batching.

Counterpart of the JAX package's `serving/kvcache.py` (the PagedAttention
design, Kwon et al., SOSP'23, with a RadixAttention-style prefix index):

- **One physical pool, fixed at load time.** Per layer, keys and values
  live in ``(L, P, page_size, H, D)`` tensors allocated once when the
  servable loads; every step sees these exact shapes.
- **Per-slot page tables.** Each decode *slot* owns a row of
  ``max_context // page_size`` physical page ids. Logical position ``t``
  lives at physical page ``table[t // page_size]``, offset
  ``t % page_size``; pages are allocated as a sequence crosses page
  boundaries.
- **The dump page.** Physical page 0 is never allocated. Writes from
  inactive slots and from prompt-padding positions are steered to page
  0, so the step needs no dynamic shape or conditional write. Several
  such writes may hit one (page, offset) in one scatter; which one wins
  is undefined, and nobody reads page 0.

Page sharing:

- **Refcounts + a radix index.** Every full, page-aligned block of prompt
  tokens is keyed by its token bytes in a trie rooted at the empty
  prefix; a node maps that block (in the context of its ancestors) to the
  one physical page holding its K/V. ``admit_prompt()`` maps every
  matched page read-shared into the new slot's page table; only the
  uncached suffix needs prefill.
- **Copy-on-write.** Shared pages are never written, except when a
  page-aligned prompt is *fully* cached: its last token must still be
  recomputed for the first-token logits, and that write would land in
  the last shared page, so admit hands back a (src, dst) pair the engine
  copies on the device first.
- **Release retains, pressure evicts.** Indexed pages whose refcount
  reaches zero move to an LRU *retained set*; allocation takes free
  pages first and evicts retained ones (leaf first) only under pool
  pressure.

The host side (`KVCacheState`) is numpy and free lists; the page table
crosses to the device as a small int32 operand each call. The device side
is the gather/scatter helpers the engine calls, which update the pools in
place (the reference donates its pools to every compiled call).

Tiered KV fabric (`kvfabric.py`): every radix node carries the chained
digest of its prefix path. With a host spill tier attached
(`attach_spill`), an evicted retained page demotes to host RAM before it
is unindexed, and an admission whose device walk stops short promotes
the following blocks back (`_promote_locked`). `adopt_pages` lands
shipped pages (a disaggregated prefill) as retained prefix pages.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch import monitor
from deeplearning4j_tpu_torch.serving import kvfabric
from deeplearning4j_tpu_torch.util.locks import DiagnosedLock

log = logging.getLogger("deeplearning4j_tpu_torch")

#: physical page 0 — the write sink for inactive slots / padded positions.
DUMP_PAGE = 0


class PagePoolExhaustedError(RuntimeError):
    """No free physical page for a sequence that must grow (the caller
    stalls the slot or sheds the join; this never crashes a step)."""


@dataclasses.dataclass(frozen=True)
class AdmitInfo:
    """Result of a token-aware admission (`admit_prompt`).

    cached_len prompt positions are already present in pages mapped
    read-shared into the slot; prefill only needs [cached_len, len).
    When the whole (page-aligned) prompt was cached, cow_src/cow_dst name
    the page the engine must copy before the forced last-token recompute
    writes into it."""
    slot: int
    cached_len: int
    cow_src: Optional[int] = None
    cow_dst: Optional[int] = None


class _RadixNode:
    """One full token block in the context of its ancestors -> the
    canonical physical page holding its K/V."""

    __slots__ = ("key", "parent", "children", "page", "digest")

    def __init__(self, key: Optional[bytes], parent: "Optional[_RadixNode]",
                 page: int = DUMP_PAGE, digest: bytes = b""):
        self.key = key
        self.parent = parent
        self.children: Dict[bytes, "_RadixNode"] = {}
        self.page = page
        #: chained prefix-path digest (kvfabric.chain_digests semantics):
        #: the page's identity in the spill tier and on the wire
        self.digest = digest


#: stats key -> the reference's counter family (name, help)
_CACHE_FAMILIES = {
    "hits": ("serving_decode_kv_cache_hits_total",
             "Admissions that reused a cached prompt prefix "
             "(>= one full page of KV skipped prefill)"),
    "misses": ("serving_decode_kv_cache_misses_total",
               "Admissions with no cached prefix (full prefill)"),
    "evictions": ("serving_decode_kv_cache_evictions_total",
                  "Prefix-cache entries evicted under pool pressure (LRU "
                  "over the retained set; a subtree goes with its root)"),
    "page_stalls": ("serving_decode_page_stalls_total",
                    "Decode steps a slot sat out waiting for a free "
                    "KV page (pool oversubscribed)"),
}
_SPILL_FAMILIES = {
    "hits": ("serving_kv_spill_hits_total",
             "Admissions whose HBM-missed prefix blocks were "
             "served (>= one page) from the host spill tier"),
    "misses": ("serving_kv_spill_misses_total",
               "Admissions that probed the host spill tier for "
               "their uncached blocks and found none"),
    "promotions": ("serving_kv_spill_promotions_total",
                   "KV pages promoted from the host spill tier back into "
                   "the HBM pool on an admission hit"),
}


class KVCacheState:
    """Host-side bookkeeping for one engine's paged KV cache.

    Owns the slot free list, the physical-page free list, per-page
    refcounts, the radix prefix index + LRU retained set, and the numpy
    page table / sequence lengths sent with every device call.
    Thread-safe, but the expected caller is one scheduler loop.

    `stats` counts prefix-cache hits and misses, evicted cache entries and
    page stalls; `spill_stats` the spill tier's admission hits, misses
    and promoted pages."""

    def __init__(self, slots: int, page_size: int, max_context: int,
                 pool_pages: Optional[int] = None, name: str = "lm",
                 prefix_cache: bool = True):
        if page_size < 1 or slots < 1:
            raise ValueError(f"slots/page_size must be >= 1 "
                             f"(got {slots}/{page_size})")
        if max_context % page_size:
            raise ValueError(
                f"max_context {max_context} must be a multiple of "
                f"page_size {page_size}")
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.max_context = int(max_context)
        self.pages_per_slot = self.max_context // self.page_size
        # +1: the dump page. The default pool is NOT oversubscribed (every
        # slot can reach max_context); size it smaller to oversubscribe
        # memory against typical sequence lengths — joins then wait on the
        # free list when the pool runs dry.
        self.pool_pages = int(pool_pages) if pool_pages is not None \
            else 1 + self.slots * self.pages_per_slot
        if self.pool_pages < 1 + self.pages_per_slot:
            raise ValueError(
                f"pool_pages {self.pool_pages} cannot hold even one "
                f"max-context sequence ({1 + self.pages_per_slot} needed)")
        self.name = name
        self.prefix_cache = bool(prefix_cache)
        self._lock = DiagnosedLock(
            "deeplearning4j_tpu_torch.serving.kvcache.KVCacheState._lock")
        #: logical->physical page map per slot; unallocated entries point
        #: at the dump page so fixed-shape gathers/scatters stay safe
        self.page_table = np.full((self.slots, self.pages_per_slot),
                                  DUMP_PAGE, np.int32)
        self.seq_lens = np.zeros((self.slots,), np.int32)
        self.active = np.zeros((self.slots,), bool)
        self._free_slots: List[int] = list(range(self.slots))
        self._free_pages: List[int] = list(range(1, self.pool_pages))
        self._pages_per_slot_live = [0] * self.slots
        #: slot-mapping count per physical page (the dump page stays 0)
        self._ref = np.zeros((self.pool_pages,), np.int64)
        self._root = _RadixNode(None, None, digest=kvfabric.DIGEST_SEED)
        self._by_page: Dict[int, _RadixNode] = {}
        #: host-RAM spill tier (attached by the engine when configured):
        #: the store plus the device extract/land callbacks — every call
        #: happens on the scheduler thread, the one that drives the pools
        self._spill: "Optional[kvfabric.HostPageStore]" = None
        self._spill_extract: Optional[Callable[[int, bytes], bytes]] = None
        self._spill_land: Optional[Callable[[int, bytes, bytes],
                                            None]] = None
        #: leading-block digests resident ONLY in the spill tier (their
        #: device copy was evicted) — still advertised for affinity routing
        self._spill_leading: set = set()
        #: indexed pages with refcount 0, insertion order == LRU order
        self._retained: "OrderedDict[int, None]" = OrderedDict()
        #: pages with refcount >= 2, maintained on ref transitions
        self._shared_count = 0
        self.stats = {"hits": 0, "misses": 0, "evictions": 0,
                      "page_stalls": 0}
        self.spill_stats = {"hits": 0, "misses": 0, "promotions": 0}
        self._gauges()

    # ------------------------------------------------------------- metrics
    def _count(self, table: dict, key: str, n: int = 1):
        """Count `n` in `stats` or `spill_stats` and in the reference's
        counter family for it."""
        table[key] += n
        name, help_ = (_SPILL_FAMILIES if table is self.spill_stats
                       else _CACHE_FAMILIES)[key]
        monitor.counter(name, help_, labels=("model",)).inc(
            n, model=self.name)

    def _gauges(self):
        used = self.pool_pages - 1 - len(self._free_pages) \
            - len(self._retained)
        monitor.gauge("serving_decode_page_pool_used",
                      "KV-cache pages referenced by live slots",
                      labels=("model",)).set(used, model=self.name)
        monitor.gauge("serving_decode_page_pool_pages",
                      "Total allocatable KV-cache pages in the pool",
                      labels=("model",)).set(self.pool_pages - 1,
                                             model=self.name)
        monitor.gauge("serving_decode_slot_occupancy",
                      "Active decode slots (in-flight sequences)",
                      labels=("model",)).set(int(self.active.sum()),
                                             model=self.name)
        monitor.gauge("serving_decode_kv_shared_pages",
                      "KV pages currently mapped by more than one slot "
                      "(prefix sharing engaged)",
                      labels=("model",)).set(self._shared_count,
                                             model=self.name)
        monitor.gauge("serving_decode_kv_retained_pages",
                      "Released prefix pages held in the LRU retained "
                      "set for future reuse (reclaimed under pressure)",
                      labels=("model",)).set(len(self._retained),
                                             model=self.name)

    # ------------------------------------------------------ spill tier
    def attach_spill(self, store, extract_fn, land_fn):
        """Wire the host-RAM spill tier in: `store` holds demoted
        frames, `extract_fn(page, digest) -> bytes` packs one device
        page, `land_fn(page, payload, digest)` writes one frame back.
        Both callbacks touch the device pools, so every spill path
        (eviction inside an admission / ensure_page, promotion inside
        admit_prompt) must run on the scheduler thread — the same
        one-thread contract the rest of this cache assumes."""
        self._spill = store
        self._spill_extract = extract_fn
        self._spill_land = land_fn

    def _promote_locked(self, node: _RadixNode, rest_keys: List[bytes],
                        pins: List[int]) -> List[int]:
        """Promote-on-hit: extend a device radix match block by block
        from the host spill tier. Each promoted page is landed, indexed,
        and ref-pinned (appended to `pins`; the caller unrefs after
        mapping or rollback) so the allocation of a later block can never
        evict an earlier one mid-promotion. Stops at the first absent
        digest, dry pool, or land failure — partial promotion is just a
        shorter cached prefix."""
        pages: List[int] = []
        dig = node.digest
        for key in rest_keys:
            dig = hashlib.sha256(dig + key).digest()
            if not self._spill.contains(dig):
                break
            page = self._take_page_locked()
            if page is None:
                break
            payload = self._spill.get(dig)
            ok = payload is not None
            if ok:
                try:
                    self._spill_land(page, payload, dig)
                except Exception:   # noqa: BLE001 — a corrupt/mis-
                    # shaped host frame must degrade to a cache miss
                    # (the suffix prefills normally), never fail the
                    # admission that probed it
                    log.exception(
                        "kvcache[%s]: spill promotion failed; dropping "
                        "host frame", self.name)
                    self._spill.drop(dig)
                    ok = False
            if not ok:
                self._ref[page] = 0
                self._free_pages.append(page)
                break
            child = _RadixNode(key, node, page, digest=dig)
            node.children[key] = child
            self._by_page[page] = child
            self._ref[page] = 1         # pinned until the admission
            pins.append(page)           # maps it (or rolls back)
            if node is self._root:
                self._spill_leading.discard(dig)
            self._count(self.spill_stats, "promotions")
            node = child
            pages.append(page)
        return pages

    # ------------------------------------------------- page accounting
    def _unref_locked(self, page: int):
        """One slot mapping gone: route a zero-ref page to the retained
        set (still indexed — future prompts can share it) or free it."""
        if page == DUMP_PAGE:
            return
        if self._ref[page] > 0:
            if self._ref[page] == 2:
                self._shared_count -= 1
            self._ref[page] -= 1
        if self._ref[page] == 0:
            if page in self._by_page:
                # MRU on release: the prefix was just used end-to-end
                self._retained[page] = None
                self._retained.move_to_end(page)
            else:
                self._free_pages.append(page)

    def _ref_locked(self, page: int):
        self._ref[page] += 1
        if self._ref[page] == 2:
            self._shared_count += 1
        self._retained.pop(page, None)

    def _demote_locked(self, node: _RadixNode):
        """Spill one about-to-be-freed retained page to the host tier.

        ORDER IS THE CONTRACT: the host copy must be durable (put()
        returned) BEFORE the caller unindexes/frees the device copy —
        otherwise there is a window where the index still answers a hit
        that resolves to a freed (reusable, soon-garbage) page. A
        demotion failure only loses cache, never data."""
        if self._spill is None or not node.digest:
            return
        try:
            payload = self._spill_extract(node.page, node.digest)
            if self._spill.put(node.digest, payload) \
                    and node.parent is self._root:
                self._spill_leading.add(node.digest)
        except Exception:   # noqa: BLE001 — a failed demotion must
            # degrade to a plain eviction (cache loss), never crash the
            # allocation path that triggered it
            log.exception("kvcache[%s]: spill demotion failed; page %d "
                          "evicts without a host copy", self.name,
                          node.page)

    def _drop_subtree_locked(self, node: _RadixNode) -> int:
        """Unindex `node` and every descendant; retained pages demote to
        the spill tier (host copy durable first) then free, in-use pages
        merely lose future shareability. Returns the number of cache
        entries evicted."""
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        stack, evicted = [node], 0
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children = {}
            if self._by_page.get(n.page) is n:
                if n.page in self._retained:
                    # durable host copy FIRST — only then unindex + free
                    self._demote_locked(n)
                    del self._by_page[n.page]
                    del self._retained[n.page]
                    self._free_pages.append(n.page)
                else:
                    del self._by_page[n.page]
                evicted += 1
        return evicted

    def _evict_locked(self) -> bool:
        """Reclaim one LRU retained entry (leaf-preferred: drop a chain's
        tail before its root so the hot head of a prefix survives
        longest). Returns False when nothing is evictable."""
        victim = None
        # oldest first; skipped entries are internal nodes of a chain
        # released root-before-tail, so the first leaf surfaces within
        # one chain depth (<= pages_per_slot probes), not O(retained)
        for page in self._retained:
            node = self._by_page.get(page)
            if node is not None and not node.children:
                victim = page
                break
        if victim is None:                          # every retained node
            victim = next(iter(self._retained), None)   # has in-use kids
        if victim is None:
            return False
        self._count(self.stats, "evictions",
                    self._drop_subtree_locked(self._by_page[victim]))
        return True

    def _take_page_locked(self) -> Optional[int]:
        """One fresh page: free list first, then LRU eviction of the
        retained set; None when the pool is genuinely dry."""
        while True:
            if self._free_pages:
                return self._free_pages.pop()
            if not self._retained or not self._evict_locked():
                return None

    # ------------------------------------------------------ radix walking
    def _blocks(self, tokens) -> Tuple[np.ndarray, List[bytes]]:
        """Canonical (flat, contiguous int32) token view + the trie key
        of every FULL page-aligned block. The one definition indexing and
        lookup share: the trie matches raw token bytes."""
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32)
                                      .reshape(-1))
        ps = self.page_size
        keys = [tokens[i * ps:(i + 1) * ps].tobytes()
                for i in range(int(tokens.size) // ps)]
        return tokens, keys

    def _walk_locked(self, keys: List[bytes]
                     ) -> Tuple[_RadixNode, List[int]]:
        """Longest indexed prefix of `keys`: (deepest matched node, its
        canonical pages root-to-match)."""
        node, pages = self._root, []
        for key in keys:
            child = node.children.get(key)
            if child is None:
                break
            pages.append(child.page)
            node = child
        return node, pages

    # ----------------------------------------------------------- lifecycle
    def pages_for(self, length: int) -> int:
        """Physical pages needed to hold `length` cached positions."""
        return (int(length) + self.page_size - 1) // self.page_size

    def _check_capacity(self, prompt_len: int):
        if self.pages_for(prompt_len) > self.pages_per_slot:
            raise ValueError(
                f"kvcache[{self.name}]: {prompt_len} cached positions "
                f"exceed per-slot capacity ({self.max_context}); the "
                "caller must validate prompt length first")

    def admit(self, prompt_len: int) -> Optional[int]:
        """Token-less admission: claim a slot + fresh pages covering the
        prompt, no sharing and no later retention. None when either
        resource is exhausted (the join waits — never an error)."""
        self._check_capacity(prompt_len)
        need = self.pages_for(prompt_len)
        with self._lock:
            return self._admit_locked(prompt_len, [], need)

    def admit_prompt(self, tokens) -> Optional[AdmitInfo]:
        """Token-aware admission: resolve the longest cached prefix of
        full page-aligned blocks, map those pages read-shared, allocate
        fresh pages for the rest. None when out of slots/pages.

        A fully-cached page-aligned prompt still must recompute its last
        token, and that write would diverge the last shared page — the
        returned AdmitInfo then carries a (cow_src, cow_dst) pair the
        engine copies on the device before the suffix prefill."""
        tokens, keys = self._blocks(tokens)
        prompt_len = int(tokens.size)
        if prompt_len < 1:
            raise ValueError("admit_prompt needs at least one token")
        self._check_capacity(prompt_len)
        need = self.pages_for(prompt_len)
        with self._lock:
            pins: List[int] = []
            if self.prefix_cache:
                deepest, matched = self._walk_locked(keys)
                if self._spill is not None and len(matched) < len(keys):
                    # the device walk stopped short: probe the host tier.
                    # Matched pages get ref-pinned first — promotion
                    # allocates pages, allocation can evict, and an
                    # eviction must never reach a page this admission
                    # is about to map read-shared
                    for p in matched:
                        self._ref_locked(p)
                        pins.append(p)
                    promoted = self._promote_locked(
                        deepest, keys[len(matched):], pins)
                    self._count(self.spill_stats, "hits",
                                int(bool(promoted)))
                    self._count(self.spill_stats, "misses",
                                int(not promoted))
                    matched = matched + promoted
            else:
                matched = []
            cached_len = len(matched) * self.page_size
            cow_src = None
            if cached_len and cached_len >= prompt_len:
                # fully covered: leave the last token to prefill; its
                # write diverges the final shared page -> copy-on-write
                cached_len = prompt_len - 1
                cow_src = matched[-1]
                shared = matched[:-1]
            else:
                shared = matched
            slot = self._admit_locked(prompt_len, shared, need, pin=cow_src)
            for p in pins:
                self._unref_locked(p)
            if slot is None:
                return None
            cow_dst = None if cow_src is None \
                else int(self.page_table[slot, len(shared)])
            if self.prefix_cache:
                hit = cached_len > 0
                self._count(self.stats, "hits", int(hit))
                self._count(self.stats, "misses", int(not hit))
            self._gauges()
            return AdmitInfo(slot, cached_len, cow_src, cow_dst)

    def _admit_locked(self, prompt_len: int, shared: Sequence[int],
                      need: int, pin: Optional[int] = None
                      ) -> Optional[int]:
        """Map `shared` read-shared + allocate the remaining fresh pages
        into a free slot; all-or-nothing (rolls back on pool pressure).
        `pin` ref-pins an extra page (the COW source) so eviction cannot
        reach it between admission and the on-device copy."""
        if not self._free_slots:
            return None
        for p in shared:
            self._ref_locked(p)
        if pin is not None:
            self._ref_locked(pin)
        fresh: List[int] = []
        for _ in range(need - len(shared)):
            p = self._take_page_locked()
            if p is None:
                for q in fresh:
                    self._ref[q] = 0
                    self._free_pages.append(q)
                for q in shared:
                    self._unref_locked(q)
                if pin is not None:
                    self._unref_locked(pin)
                return None
            self._ref[p] = 1
            fresh.append(p)
        slot = self._free_slots.pop()
        self.page_table[slot, :] = DUMP_PAGE
        for i, p in enumerate(list(shared) + fresh):
            self.page_table[slot, i] = p
        self._pages_per_slot_live[slot] = need
        self.seq_lens[slot] = prompt_len
        self.active[slot] = True
        return slot

    def unref_page(self, page: int):
        """Drop a temporary pin (the engine calls this once the COW copy
        has executed)."""
        with self._lock:
            self._unref_locked(page)

    def register_prefix(self, slot: int, tokens):
        """Index this slot's full prompt blocks (prefill is complete —
        every mapped prompt page now holds final K/V). Blocks already
        indexed keep their existing canonical page; a racing duplicate
        prompt simply fails to index and frees on release."""
        if not self.prefix_cache:
            return
        _, keys = self._blocks(tokens)
        with self._lock:
            node = self._root
            for i, key in enumerate(keys):
                child = node.children.get(key)
                if child is None:
                    page = int(self.page_table[slot, i])
                    if page == DUMP_PAGE or page in self._by_page:
                        return          # defensive: never index the dump
                    child = _RadixNode(
                        key, node, page,
                        digest=hashlib.sha256(node.digest + key).digest())
                    node.children[key] = child
                    self._by_page[page] = child
                node = child

    def adopt_pages(self, tokens, land_fn) -> int:
        """Land externally computed KV pages (a disaggregated-prefill
        shipment) straight into the radix index as zero-ref retained
        pages: `land_fn(i, page)` writes block i's frame into physical
        page `page` (raising on corruption — the page is freed and the
        error surfaces cleanly). Blocks already indexed are skipped, so
        a duplicate shipment is idempotent. The NEXT `admit_prompt` of
        this prefix then hits exactly like a locally prefilled one.
        Returns the number of pages adopted."""
        if not self.prefix_cache:
            return 0
        tokens, keys = self._blocks(tokens)
        if not keys:
            return 0
        adopted = 0
        pins: List[int] = []
        with self._lock:
            node = self._root
            try:
                for i, key in enumerate(keys):
                    child = node.children.get(key)
                    if child is not None:
                        # pin the existing chain so a later block's
                        # allocation cannot evict it mid-adoption
                        self._ref_locked(child.page)
                        pins.append(child.page)
                        node = child
                        continue
                    page = self._take_page_locked()
                    if page is None:
                        break           # pool dry: partial adoption is
                        # just a shorter cached prefix
                    try:
                        land_fn(i, page)
                    except Exception:
                        self._ref[page] = 0
                        self._free_pages.append(page)
                        raise
                    child = _RadixNode(
                        key, node, page,
                        digest=hashlib.sha256(node.digest + key).digest())
                    node.children[key] = child
                    self._by_page[page] = child
                    self._ref[page] = 1
                    pins.append(page)
                    adopted += 1
                    node = child
            finally:
                for p in pins:
                    self._unref_locked(p)
        return adopted

    def ownership_digests(self, limit: int = 64) -> List[str]:
        """Leading-block (depth-1) prefix digests this cache can serve
        hot — device-indexed roots plus host-spilled ones — as short hex
        handles (the health document's prefix-affinity advertisement)."""
        with self._lock:
            out = [c.digest.hex()[:16]
                   for c in self._root.children.values() if c.digest]
            for d in self._spill_leading:
                h = d.hex()[:16]
                if h not in out:
                    out.append(h)
            return out[:max(0, int(limit))]

    def ensure_page(self, slot: int) -> bool:
        """Guarantee a physical page exists for this slot's NEXT position
        (``seq_lens[slot]``). Returns False when the pool is dry or the
        context is full — the caller masks the slot out of this step."""
        with self._lock:
            pos = int(self.seq_lens[slot])
            if pos >= self.max_context:
                return False            # context cap; caller finishes it
            idx = pos // self.page_size
            if idx < self._pages_per_slot_live[slot]:
                return True
            page = self._take_page_locked()
            if page is None:
                self._count(self.stats, "page_stalls")
                return False
            self._ref[page] = 1
            self.page_table[slot, idx] = page
            self._pages_per_slot_live[slot] = idx + 1
            self._gauges()
            return True

    def ensure_capacity(self, slot: int, n: int) -> bool:
        """Guarantee physical pages for this slot's next ``n`` positions.
        Returns False when the context cap or a dry pool blocks any of
        them; pages allocated before the pool ran dry stay mapped."""
        with self._lock:
            pos = int(self.seq_lens[slot])
            if pos + n > self.max_context:
                return False
            if n < 1:
                return True
            need_idx = (pos + n - 1) // self.page_size
            allocated = False
            while self._pages_per_slot_live[slot] <= need_idx:
                page = self._take_page_locked()
                if page is None:
                    self._count(self.stats, "page_stalls")
                    if allocated:
                        self._gauges()
                    return False
                idx = self._pages_per_slot_live[slot]
                self._ref[page] = 1
                self.page_table[slot, idx] = page
                self._pages_per_slot_live[slot] = idx + 1
                allocated = True
            if allocated:
                self._gauges()
            return True

    def advance(self, slot: int):
        """One token appended at ``seq_lens[slot]`` by the decode step."""
        self.seq_lens[slot] += 1

    def release(self, slot: int):
        """Sequence finished: unreference its pages (indexed ones join
        the retained set, the rest free) and return the slot."""
        with self._lock:
            if not self.active[slot]:
                return
            n = self._pages_per_slot_live[slot]
            for p in self.page_table[slot, :n]:
                self._unref_locked(int(p))
            self.page_table[slot, :] = DUMP_PAGE
            self._pages_per_slot_live[slot] = 0
            self.seq_lens[slot] = 0
            self.active[slot] = False
            self._free_slots.append(slot)
            self._gauges()

    # -------------------------------------------------------------- status
    def active_slots(self) -> List[int]:
        return [i for i in range(self.slots) if self.active[i]]

    def utilization(self) -> float:
        """Share of the allocatable pool held by live slots (retained
        prefix pages count as free: they are reclaimable cache)."""
        total = self.pool_pages - 1
        return (total - self.free_pages()) / max(1, total)

    def free_pages(self) -> int:
        """Allocatable pages: truly free + retained (the retained set is
        reclaimable cache, not working memory)."""
        with self._lock:
            return len(self._free_pages) + len(self._retained)

    def retained_pages(self) -> int:
        with self._lock:
            return len(self._retained)

    def ref_count(self, page: int) -> int:
        with self._lock:
            return int(self._ref[page])

    def cached_prefix_len(self, tokens) -> int:
        """Longest currently-indexed prefix (full blocks) of `tokens` in
        tokens — a read-only probe, no LRU touch."""
        _, keys = self._blocks(tokens)
        with self._lock:
            return len(self._walk_locked(keys)[1]) * self.page_size

    def describe(self) -> dict:
        with self._lock:
            return {
                "slots": self.slots,
                "active_slots": int(self.active.sum()),
                "page_size": self.page_size,
                "max_context": self.max_context,
                "pool_pages": self.pool_pages - 1,
                "pages_used": (self.pool_pages - 1 - len(self._free_pages)
                               - len(self._retained)),
                "prefix_cache": self.prefix_cache,
                "retained_pages": len(self._retained),
                "shared_pages": self._shared_count,
                "spill": None if self._spill is None
                else dict(self._spill.describe(), **self.spill_stats),
                "stats": dict(self.stats),
            }


# --------------------------------------------------------------------------
# Device-side helpers: the pools are (L, P, page_size, H, D) tensors,
# updated in place; index operands are int64 tensors on the pools' device.
# --------------------------------------------------------------------------
def append_token_kv(kpool, vpool, layer: int, k, v, phys, off):
    """Scatter one new (key, value) row per slot into the pools.

    k/v: (S, H, D); phys/off: (S,) physical page id and in-page offset per
    slot (inactive slots steered to DUMP_PAGE by the caller)."""
    kpool[layer].index_put_((phys, off), k)
    vpool[layer].index_put_((phys, off), v)


def write_prompt_kv(kpool, vpool, layer: int, k_seq, v_seq, page_row,
                    page_size: int):
    """Write a prefilled prompt's (key, value) rows into its slot's pages.

    k_seq/v_seq: (T, H, D) with T a multiple of page_size (the prefill
    bucket); page_row: (pages_per_slot,) — entries past the prompt's
    allocation point at DUMP_PAGE, so the fixed-count scatter cannot touch
    another sequence's pages."""
    t, h, d = k_seq.shape
    npages = t // page_size
    rows = page_row[:npages]
    kpool[layer].index_put_((rows,), k_seq.reshape(npages, page_size, h, d))
    vpool[layer].index_put_((rows,), v_seq.reshape(npages, page_size, h, d))


def write_chunk_kv(kpool, vpool, layer: int, k_seq, v_seq, phys, off):
    """Scatter a prefill chunk's (key, value) rows by absolute position.

    No page alignment is assumed (the COW recompute starts mid-page).
    k_seq/v_seq: (T, H, D); phys/off: (T,) physical page and in-page
    offset per row, with padding rows steered to DUMP_PAGE by the
    caller."""
    kpool[layer].index_put_((phys, off), k_seq)
    vpool[layer].index_put_((phys, off), v_seq)


def gather_kv(kpool, vpool, layer: int, page_table, max_context: int):
    """Page-table gather back to dense per-slot key/value sequences.

    page_table: (S, pages_per_slot). Returns (keys, values) shaped
    (S, max_context, H, D); positions past a slot's live length hold
    stale or dump garbage — the attention mask is the single source of
    validity."""
    s = page_table.shape[0]
    h, d = kpool.shape[-2], kpool.shape[-1]
    keys = kpool[layer][page_table].reshape(s, max_context, h, d)
    vals = vpool[layer][page_table].reshape(s, max_context, h, d)
    return keys, vals


def copy_page(kpool, vpool, src: int, dst: int):
    """Copy one physical page across every layer (the COW divergence)."""
    kpool[:, dst] = kpool[:, src]
    vpool[:, dst] = vpool[:, src]


def default_prefill_buckets(page_size: int, max_context: int
                            ) -> Sequence[int]:
    """Prefill bucket ladder: page-aligned, geometric (x4), capped by and
    always including max_context."""
    buckets, b = [], page_size
    while b < max_context:
        buckets.append(b)
        b *= 4
    buckets.append(max_context)
    return tuple(sorted(set(buckets)))
