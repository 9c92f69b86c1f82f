"""The port's serving/kvcache.py against the JAX package's.

The host side (`KVCacheState`) is held to the reference operation by
operation; the device helpers bit for bit on random pools (they only
move values). Where a scatter writes one (page, offset) twice — padding
and inactive rows steered to the dump page — which write wins is
undefined, so page 0 is left out of that comparison.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.serving import kvcache as jkv
from deeplearning4j_tpu_torch.serving import kvcache as pkv
from deeplearning4j_tpu_torch.serving.kvcache import DUMP_PAGE, KVCacheState


# ------------------------------------------- the reference's host tests
def test_kvcache_alloc_release_and_dump_page():
    c = KVCacheState(slots=2, page_size=4, max_context=16, name="kvt")
    assert c.pool_pages == 1 + 2 * 4          # page 0 is the dump page
    s = c.admit(6)                            # needs ceil(6/4) = 2 pages
    assert s is not None
    assert c.describe()["pages_used"] == 2
    assert (c.page_table[s, :2] > 0).all()    # never the dump page
    assert (c.page_table[s, 2:] == 0).all()
    # position 6 lives inside page 1 (already allocated); 8 needs page 2
    assert c.ensure_page(s)
    c.seq_lens[s] = 8
    assert c.ensure_page(s)
    assert c.describe()["pages_used"] == 3
    c.release(s)
    assert c.describe()["pages_used"] == 0
    assert not c.active[s]


def test_kvcache_exhaustion_blocks_admission_and_growth():
    # pool sized for exactly one max-context sequence
    c = KVCacheState(slots=2, page_size=4, max_context=16, pool_pages=5,
                     name="kvx")
    a = c.admit(16 - 4)
    assert a is not None                      # took 3 of 4 pages
    assert c.admit(8) is None                 # 2 pages wanted, 1 free
    b = c.admit(3)                            # 1 page still fits
    assert b is not None
    c.seq_lens[b] = 4
    assert not c.ensure_page(b)               # pool dry -> stall, no crash
    assert c.stats["page_stalls"] == 1
    c.release(a)
    assert c.ensure_page(b)                   # freed pages recycle


def test_kvcache_rejects_unaligned_context():
    with pytest.raises(ValueError):
        KVCacheState(slots=1, page_size=8, max_context=20)


def test_kvcache_prefix_reuse_refcount_lifecycle():
    """Full-block prefix sharing: a second prompt with a common prefix
    maps the SAME physical pages (ref 2), release retains indexed pages
    instead of freeing, and a later identical prefix still hits."""
    c = KVCacheState(slots=4, page_size=4, max_context=16, name="kvp")
    t = np.arange(12, dtype=np.int32)             # 3 full blocks
    a = c.admit_prompt(t)
    assert a.cached_len == 0 and a.cow_src is None  # cold
    c.register_prefix(a.slot, t)
    b = c.admit_prompt(np.concatenate([t[:8], [99, 98]]).astype(np.int32))
    assert b.cached_len == 8
    assert (c.page_table[b.slot, :2] == c.page_table[a.slot, :2]).all()
    shared_page = int(c.page_table[a.slot, 0])
    assert c.ref_count(shared_page) == 2
    c.release(a.slot)
    assert c.ref_count(shared_page) == 1          # b still maps it
    c.release(b.slot)
    assert c.ref_count(shared_page) == 0
    assert c.retained_pages() == 3                # a's 3 indexed blocks
    assert c.cached_prefix_len(t) == 12
    d = c.admit_prompt(np.concatenate([t, [7]]).astype(np.int32))
    assert d.cached_len == 12                     # full retained chain hit
    c.release(d.slot)
    assert c.stats["hits"] == 2 and c.stats["misses"] == 1


def test_kvcache_cow_on_full_prefix_and_dump_page_never_shared():
    c = KVCacheState(slots=4, page_size=4, max_context=16, name="kvcow")
    t = np.arange(8, dtype=np.int32)              # exactly 2 blocks
    a = c.admit_prompt(t)
    c.register_prefix(a.slot, t)
    b = c.admit_prompt(t)                         # identical, fully cached
    assert b.cached_len == 7                      # forced last-token redo
    assert b.cow_src == int(c.page_table[a.slot, 1])
    assert b.cow_dst == int(c.page_table[b.slot, 1])
    assert b.cow_dst not in (b.cow_src, DUMP_PAGE)
    assert c.page_table[b.slot, 0] == c.page_table[a.slot, 0]
    assert c.page_table[b.slot, 1] != c.page_table[a.slot, 1]
    assert c.ref_count(b.cow_src) == 2            # a's mapping + the pin
    c.unref_page(b.cow_src)
    assert c.ref_count(b.cow_src) == 1
    c.release(a.slot)
    c.release(b.slot)
    assert c.ref_count(DUMP_PAGE) == 0
    assert DUMP_PAGE not in c._by_page            # never indexed
    assert all(c._pages_per_slot_live[s] == 0 for s in range(c.slots))


def test_kvcache_lru_eviction_under_pool_pressure():
    c = KVCacheState(slots=2, page_size=4, max_context=8, pool_pages=5,
                     name="kvev")                 # 4 usable pages
    a_t = np.arange(8, dtype=np.int32)
    b_t = np.arange(8, dtype=np.int32) + 100
    c_t = np.arange(8, dtype=np.int32) + 200
    a = c.admit_prompt(a_t)
    c.register_prefix(a.slot, a_t)
    c.release(a.slot)
    b = c.admit_prompt(b_t)
    c.register_prefix(b.slot, b_t)
    c.release(b.slot)
    assert c.retained_pages() == 4 and c.free_pages() == 4
    d = c.admit_prompt(c_t)                       # needs 2 fresh pages
    assert d is not None and d.cached_len == 0
    assert c.stats["evictions"] == 2              # a's chain went, LRU
    assert c.cached_prefix_len(a_t) == 0          # evicted
    assert c.cached_prefix_len(b_t) == 8          # fresher chain survived
    c.release(d.slot)


def test_kvcache_tokenless_admit_keeps_legacy_semantics():
    c = KVCacheState(slots=2, page_size=4, max_context=16, name="kvleg")
    s = c.admit(10)
    assert s is not None
    c.release(s)
    assert c.retained_pages() == 0
    assert c.free_pages() == c.pool_pages - 1


def test_spill_tier_attaches_and_pages_adopt():
    """attach_spill wires a host tier that an eviction demotes into and
    an admission promotes from; adopt_pages lands shipped pages as
    retained prefix pages (idempotent), which the next admission hits."""
    c = KVCacheState(slots=1, page_size=4, max_context=12, pool_pages=4)
    store, landed = {}, []

    class Store:
        contains = store.__contains__
        get = store.get

        def put(self, key, payload):
            store[key] = payload
            return True

        def drop(self, key):
            store.pop(key, None)

        def describe(self):
            return {"resident": len(store)}

    c.attach_spill(Store(), lambda page, dig: b"page%d" % page,
                   lambda page, payload, dig: landed.append(payload))
    t = np.arange(8)
    a = c.admit_prompt(t)
    c.register_prefix(a.slot, t)
    c.release(a.slot)
    assert c.retained_pages() == 2
    s = c.admit(12)                       # evicts both: demoted first
    assert len(store) == 2 and c.retained_pages() == 0
    c.release(s)
    a = c.admit_prompt(t)                 # promoted back from the tier
    assert a.cached_len == 7 and len(landed) == 2
    assert c.describe()["spill"]["promotions"] == 2
    c.release(a.slot)
    d = KVCacheState(slots=1, page_size=4, max_context=8)
    lands = []
    assert d.adopt_pages(t, lambda i, page: lands.append((i, page))) == 2
    assert d.adopt_pages(t, lambda i, page: lands.append((i, page))) == 0
    assert [i for i, _ in lands] == [0, 1]
    assert d.cached_prefix_len(t) == 8 and d.retained_pages() == 2


# ------------------------------------ operation by operation, seeded
def _state(c):
    return (c.page_table.copy(), c.seq_lens.copy(), c.active.copy(),
            c.free_pages(), c.retained_pages(), list(c._free_slots),
            list(c._free_pages), c._ref.copy(), c._shared_count)


@pytest.mark.parametrize("seed,pool_pages", [(0, None), (1, 9), (2, 7)])
def test_random_operations_match_reference(seed, pool_pages):
    """A seeded random sequence of admit_prompt, ensure_page,
    ensure_capacity, advance, register_prefix, release (and the COW
    unpin) applied to both caches:
    equal AdmitInfo, page tables, seq_lens and free-page counts after
    every operation. Small pools force eviction and stalls; prompts
    share prefixes so the radix index and COW engage."""
    rs = np.random.RandomState(seed)
    kw = dict(slots=3, page_size=4, max_context=16, pool_pages=pool_pages)
    j, p = jkv.KVCacheState(name=f"rand{seed}", **kw), KVCacheState(**kw)
    stems = [rs.randint(0, 50, 16).astype(np.int32) for _ in range(3)]
    live = {}                                     # slot -> prompt
    for _ in range(400):
        op = rs.choice(["admit", "ensure", "capacity", "advance",
                        "register", "release"],
                       p=[0.3, 0.15, 0.1, 0.2, 0.1, 0.15])
        if op == "admit":
            stem = stems[rs.randint(3)]
            n = int(rs.randint(1, 16))
            prompt = stem[:n].copy()
            if rs.rand() < 0.3:
                prompt[-1] = rs.randint(50, 60)
            ji, pi = j.admit_prompt(prompt), p.admit_prompt(prompt)
            assert (ji is None) == (pi is None)
            if pi is not None:
                assert (pi.slot, pi.cached_len, pi.cow_src, pi.cow_dst) == \
                    (ji.slot, ji.cached_len, ji.cow_src, ji.cow_dst)
                if pi.cow_src is not None:
                    j.unref_page(ji.cow_src)
                    p.unref_page(pi.cow_src)
                live[pi.slot] = prompt
        elif live:
            slot = int(rs.choice(sorted(live)))
            if op == "ensure":
                assert j.ensure_page(slot) == p.ensure_page(slot)
            elif op == "capacity":
                n = int(rs.randint(0, 7))
                assert j.ensure_capacity(slot, n) == p.ensure_capacity(slot, n)
            elif op == "advance":
                if p.seq_lens[slot] < 16 and p.ensure_page(slot):
                    assert j.ensure_page(slot)
                    j.advance(slot)
                    p.advance(slot)
            elif op == "register":
                j.register_prefix(slot, live[slot])
                p.register_prefix(slot, live[slot])
            else:
                j.release(slot)
                p.release(slot)
                del live[slot]
        js, ps = _state(j), _state(p)
        for a, b in zip(js, ps):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert p.stats["hits"] > 0
    assert j.describe()["pages_used"] == p.describe()["pages_used"]


def test_default_prefill_buckets_match_reference():
    for ps, ctx in ((16, 2048), (8, 32), (4, 16), (16, 16), (8, 8 * 65)):
        assert pkv.default_prefill_buckets(ps, ctx) == \
            jkv.default_prefill_buckets(ps, ctx)


# ------------------------------------------------------ device helpers
L, P, PS, H, D = 2, 9, 4, 3, 8


def _pools(seed):
    rs = np.random.RandomState(seed)
    k = rs.randn(L, P, PS, H, D).astype(np.float32)
    v = rs.randn(L, P, PS, H, D).astype(np.float32)
    return k, v


def _port(k, v):
    return torch.from_numpy(k.copy()), torch.from_numpy(v.copy())


def _same(ref_pools, port_pools, skip_dump=False):
    lo = 1 if skip_dump else 0
    for r, g in zip(ref_pools, port_pools):
        np.testing.assert_array_equal(g.numpy()[:, lo:],
                                      np.asarray(r)[:, lo:])


def test_append_token_kv_bitwise():
    k, v = _pools(0)
    rs = np.random.RandomState(1)
    newk, newv = (rs.randn(4, H, D).astype(np.float32) for _ in range(2))
    phys = np.array([3, 0, 5, 0])                 # two inactive -> dump
    off = np.array([1, 2, 3, 2])
    ref = jkv.append_token_kv(jnp.asarray(k), jnp.asarray(v), 1,
                              jnp.asarray(newk), jnp.asarray(newv),
                              jnp.asarray(phys), jnp.asarray(off))
    pk, pv = _port(k, v)
    pkv.append_token_kv(pk, pv, 1, torch.from_numpy(newk),
                        torch.from_numpy(newv), torch.from_numpy(phys),
                        torch.from_numpy(off))
    _same(ref, (pk, pv), skip_dump=True)


def test_write_prompt_kv_bitwise():
    k, v = _pools(2)
    rs = np.random.RandomState(3)
    kseq, vseq = (rs.randn(3 * PS, H, D).astype(np.float32)
                  for _ in range(2))
    row = np.array([4, 7, 0, 0])                  # 2 live pages, then dump
    ref = jkv.write_prompt_kv(jnp.asarray(k), jnp.asarray(v), 0,
                              jnp.asarray(kseq), jnp.asarray(vseq),
                              jnp.asarray(row), PS)
    pk, pv = _port(k, v)
    pkv.write_prompt_kv(pk, pv, 0, torch.from_numpy(kseq),
                        torch.from_numpy(vseq), torch.from_numpy(row), PS)
    _same(ref, (pk, pv), skip_dump=True)
    # no duplicate: the whole pool, dump page included
    row = np.array([2, 8, 6, 1])
    ref = jkv.write_prompt_kv(jnp.asarray(k), jnp.asarray(v), 1,
                              jnp.asarray(kseq), jnp.asarray(vseq),
                              jnp.asarray(row), PS)
    pk, pv = _port(k, v)
    pkv.write_prompt_kv(pk, pv, 1, torch.from_numpy(kseq),
                        torch.from_numpy(vseq), torch.from_numpy(row), PS)
    _same(ref, (pk, pv))


def test_write_chunk_kv_bitwise():
    k, v = _pools(4)
    rs = np.random.RandomState(5)
    kseq, vseq = (rs.randn(6, H, D).astype(np.float32) for _ in range(2))
    pos = 3 + np.arange(6)                        # starts mid-page
    row = np.array([2, 5, 6, 0])
    phys = np.where(pos < 7, row[pos // PS], DUMP_PAGE)   # 7, 8: padding
    ref = jkv.write_chunk_kv(jnp.asarray(k), jnp.asarray(v), 1,
                             jnp.asarray(kseq), jnp.asarray(vseq),
                             jnp.asarray(phys), jnp.asarray(pos % PS))
    pk, pv = _port(k, v)
    pkv.write_chunk_kv(pk, pv, 1, torch.from_numpy(kseq),
                       torch.from_numpy(vseq), torch.from_numpy(phys),
                       torch.from_numpy(pos % PS))
    _same(ref, (pk, pv), skip_dump=True)


def test_gather_kv_and_copy_page_bitwise():
    k, v = _pools(6)
    table = np.array([[3, 1, 0, 0], [8, 2, 7, 4]])
    rk, rv = jkv.gather_kv(jnp.asarray(k), jnp.asarray(v), 1,
                           jnp.asarray(table), 4 * PS)
    pk, pv = _port(k, v)
    gk, gv = pkv.gather_kv(pk, pv, 1, torch.from_numpy(table), 4 * PS)
    assert tuple(gk.shape) == (2, 4 * PS, H, D)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    ref = jkv.copy_page(jnp.asarray(k), jnp.asarray(v), jnp.int32(5),
                        jnp.int32(2))
    pkv.copy_page(pk, pv, 5, 2)
    _same(ref, (pk, pv))
    assert torch.equal(pk[:, 2], pk[:, 5])
