"""The port's tiered KV fabric (serving/kvfabric.py and the spill and
transfer paths of kvcache.py and decode.py) against the JAX package's.

- Frames: for f32, bf16 and int8 pages, the port's KVPG page frames and
  KVXF transfer envelopes are byte for byte the reference's for the same
  arrays and digests, each package unpacks the other's frames bitwise,
  and every corruption the reference's tests make (each single-byte
  flip, each truncation, a version from the future) raises FrameError.
- The host store: the same put/get/drop sequence leaves both packages'
  stores with the same keys in the same LRU order, in the same slots.
- Decode: on one set of weights (a 2-layer, width-32, vocab-64 LM moved
  across through the checkpoint zip), a prefix demoted to the spill tier
  and promoted back, and a prefix imported from another engine (either
  package's export), decode the reference's tokens with logits within
  2e-5 (f32 matmuls summed in other orders; observed ~1e-6), and the
  servable-level parity trio of the reference's tests holds.
"""
import hashlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.serving import kvfabric as jfab
from deeplearning4j_tpu.serving.decode import (
    DecodeConfig as JaxDecodeConfig, DecodeEngine as JaxDecodeEngine,
    ServedLM as JaxServedLM,
)
from deeplearning4j_tpu.util.serialization import save_model as jax_save
from deeplearning4j_tpu_torch.serving import kvfabric as pfab
from deeplearning4j_tpu_torch.serving.batcher import ServerDrainingError
from deeplearning4j_tpu_torch.serving.decode import (
    DecodeConfig, DecodeEngine, ServedLM,
)
from deeplearning4j_tpu_torch.serving.kvcache import KVCacheState
from deeplearning4j_tpu_torch.util.serialization import load_model

LM = dict(vocab_size=64, seq_length=32, n_layers=2, n_embd=32, n_heads=4,
          mlp_ratio=2, seed=11)
BUCKETS = (8, 32)
ATOL = 2e-5
DTYPES = ("float32", "bfloat16", "int8")


# ------------------------------------------------------------ frames
def _arrays(dtype, shape=(1, 4, 2, 3), seed=7):
    """(reference numpy array, port tensor) holding the same bits."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        a = rng.integers(-128, 127, shape, dtype=np.int8)
        return a, torch.from_numpy(a.copy())
    a = rng.standard_normal(shape, dtype=np.float32)
    if dtype == "float32":
        return a, torch.from_numpy(a.copy())
    b = a.astype(ml_dtypes.bfloat16)
    return b, torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16)


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        t = x.contiguous()
        return (t.view(torch.int16) if t.dtype == torch.bfloat16
                else t).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


@pytest.mark.parametrize("dtype", DTYPES)
def test_page_frames_are_byte_identical_both_ways(dtype):
    (jk, pk), (jv, pv) = _arrays(dtype, seed=1), _arrays(dtype, seed=2)
    digest = hashlib.sha256(b"page-0").digest()
    jframe = jfab.pack_page(jk, jv, digest)
    pframe = pfab.pack_page(pk, pv, digest)
    assert pframe == jframe
    if dtype != "bfloat16":             # numpy arrays pack alike too
        assert pfab.pack_page(jk, jv, digest) == jframe
    k, v, hdr = pfab.unpack_page(jframe, expect_digest=digest)
    assert k.dtype == pk.dtype and tuple(k.shape) == jk.shape
    assert _bits(k) == _bits(jk) and _bits(v) == _bits(jv)
    assert hdr == jfab.unpack_page(jframe)[2]
    k2, v2, _ = jfab.unpack_page(pframe, expect_digest=digest)
    assert k2.dtype == jk.dtype
    assert _bits(k2) == _bits(pk) and _bits(v2) == _bits(pv)
    with pytest.raises(pfab.FrameError):
        pfab.unpack_page(jframe, expect_digest=hashlib.sha256(b"x").digest())


@pytest.mark.parametrize("dtype", DTYPES)
def test_transfer_envelopes_are_byte_identical(dtype):
    ps = 4
    toks = np.arange(8, dtype=np.int32)
    keys = [toks[:4].tobytes(), toks[4:].tobytes()]
    digs = pfab.chain_digests(keys)
    assert digs == jfab.chain_digests(keys)
    assert pfab.leading_digest(toks, ps) == jfab.leading_digest(toks, ps)
    assert pfab.leading_digest(toks[:3], ps) is None
    frames = []
    for i, d in enumerate(digs):
        (jk, pk), (jv, pv) = _arrays(dtype, seed=i), _arrays(dtype,
                                                            seed=i + 9)
        frames.append(pfab.pack_page(pk, pv, d))
        assert frames[-1] == jfab.pack_page(jk, jv, d)
    blob = pfab.pack_transfer(toks, frames, ps)
    assert blob == jfab.pack_transfer(toks, frames, ps)
    for unpack in (pfab.unpack_transfer, jfab.unpack_transfer):
        t2, f2, hdr = unpack(blob)
        assert t2.tolist() == toks.tolist() and f2 == frames
        assert hdr["page_size"] == ps and hdr["n_frames"] == 2
    with pytest.raises(ValueError):
        pfab.pack_transfer(toks[:7], frames, ps)
    shape = (2, 8, 4, 16)
    for tdt, ndt in ((torch.float32, np.float32),
                     (torch.bfloat16, ml_dtypes.bfloat16),
                     (torch.int8, np.int8)):
        assert pfab.frame_capacity(*shape, tdt) \
            == jfab.frame_capacity(*shape, ndt)


def test_every_corruption_raises_frame_error():
    """The reference's sweep: every single-byte flip and every truncation
    of a page frame, a version from the future, and every flip and a
    stride of truncations of a transfer, in the port's parsers."""
    jk, pk = _arrays("float32", (1, 2, 2, 2), seed=3)
    jv, pv = _arrays("float32", (1, 2, 2, 2), seed=4)
    frame = pfab.pack_page(pk, pv, hashlib.sha256(b"d").digest())
    for i in range(len(frame)):
        bad = bytearray(frame)
        bad[i] ^= 0xFF
        with pytest.raises(pfab.FrameError):
            pfab.unpack_page(bytes(bad))
        with pytest.raises(pfab.FrameError):
            pfab.check_frame(bytes(bad))
    for n in range(len(frame)):
        with pytest.raises(pfab.FrameError):
            pfab.unpack_page(frame[:n])
    fut = bytearray(frame)
    fut[4] = 99
    with pytest.raises(pfab.FrameError):
        pfab.unpack_page(bytes(fut))
    toks = np.arange(8, dtype=np.int32)
    digs = pfab.chain_digests([toks[:4].tobytes(), toks[4:].tobytes()])
    frames = [pfab.pack_page(pk, pv, d) for d in digs]
    blob = pfab.pack_transfer(toks, frames, 4)
    for i in range(len(blob)):
        bad = bytearray(blob)
        bad[i] ^= 0xFF
        with pytest.raises(pfab.FrameError):
            pfab.unpack_transfer(bytes(bad))
    for n in range(0, len(blob), 7):
        with pytest.raises(pfab.FrameError):
            pfab.unpack_transfer(blob[:n])


def test_host_store_lru_and_slot_reuse_match_reference():
    """One seeded sequence of put/get/drop (with MRU touches, a full
    store's LRU eviction, a same-key rewrite, an oversize reject) on both
    packages' stores: equal keys in equal LRU order, equal slots, equal
    byte accounting, equal frames back."""
    rs = np.random.RandomState(0)
    keys = [hashlib.sha256(b"k%d" % i).digest() for i in range(7)]
    j = jfab.HostPageStore(4, 64, name="kvf-ref")
    p = pfab.HostPageStore(4, 64, name="kvf-port")
    try:
        for step in range(200):
            op = rs.randint(4)
            key = keys[rs.randint(len(keys))]
            if op <= 1:
                payload = bytes(rs.randint(0, 256, rs.randint(1, 80))
                                .astype(np.uint8))
                assert p.put(key, payload) == j.put(key, payload)
            elif op == 2:
                assert p.get(key) == j.get(key)
            else:
                p.drop(key)
                j.drop(key)
            assert p.keys() == j.keys(), step
            assert dict(p._index) == dict(j._index), step
            assert sorted(p._free) == sorted(j._free)
            jd, pd = j.describe(), p.describe()
            assert {k: pd[k] for k in jd} == jd
        assert p.stats["rejects"] > 0 and p.stats["evictions"] > 0
    finally:
        j.close()
        p.close()
    assert p.get(keys[0]) is None and len(p) == 0


def test_host_store_names_the_bytes_it_cannot_get(monkeypatch):
    import multiprocessing.shared_memory as shm_mod

    def refuse(*a, **k):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(shm_mod.SharedMemory, "__init__", refuse)
    with pytest.raises(MemoryError, match=str(3 * (8 + 100))):
        pfab.HostPageStore(3, 100)


def test_eviction_demotes_before_unindexing():
    """The ordering contract: the host copy is durable (put() ran) while
    the device page is still indexed and not yet free."""
    c = KVCacheState(slots=2, page_size=4, max_context=16, pool_pages=5)
    checks = []

    class Store(pfab.HostPageStore):
        def put(self, key, payload):
            node = next((n for n in c._by_page.values()
                         if n.digest == key), None)
            assert node is not None and node.page not in c._free_pages
            checks.append(key)
            return super().put(key, payload)

    store = Store(8, 64)
    landed = []
    try:
        c.attach_spill(store, lambda page, dig: b"frame:%d:" % page
                       + dig[:8],
                       lambda page, payload, dig: landed.append(payload))
        t = np.arange(8, dtype=np.int32)
        a = c.admit_prompt(t)
        c.register_prefix(a.slot, t)
        c.release(a.slot)
        c.release(c.admit(16))
        assert len(checks) == 2 and len(store) == 2
        # leaf first: the chain's tail demotes before its head
        assert checks == pfab.chain_digests([t[:4].tobytes(),
                                            t[4:].tobytes()])[::-1]
        a2 = c.admit_prompt(t)
        assert a2.cached_len == 7 and a2.cow_src is not None
        assert len(landed) == 2 and c.spill_stats["promotions"] == 2
        c.release(a2.slot)
    finally:
        store.close()


def test_promotion_failure_degrades_to_miss():
    c = KVCacheState(slots=2, page_size=4, max_context=16)
    store = pfab.HostPageStore(4, 64)

    def bad_land(page, payload, digest):
        raise pfab.FrameError("host frame rotted")

    try:
        c.attach_spill(store, lambda p, d: b"x", bad_land)
        t = np.arange(4, dtype=np.int32)
        a = c.admit_prompt(t)
        c.register_prefix(a.slot, t)
        node = next(iter(c._by_page.values()))
        store.put(node.digest, b"frame")
        c.release(a.slot)
        c._drop_subtree_locked(node)
        a2 = c.admit_prompt(t)
        assert a2 is not None and a2.cached_len == 0
        assert not store.contains(node.digest)
        c.release(a2.slot)
    finally:
        store.close()


# ------------------------------------------------------ engines, parity
@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(JAX net, port net) with the same weights, perturbed off init."""
    jnet = JaxLM(**LM).init()
    rs = np.random.RandomState(5)
    jnet.params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rs.randn(*a.shape).astype("float32"),
        jnet.params)
    path = str(tmp_path_factory.mktemp("kvf") / "lm.zip")
    jax_save(jnet, path)
    return jnet, load_model(path, device="cpu")


def _cfg(cls, **kw):
    return cls(slots=2, page_size=8, prefill_buckets=BUCKETS, **kw)


def _evict_all(cache):
    with cache._lock:
        while cache._retained:
            cache._evict_locked()


def _hit_then_steps(engine, prompt, steps=6):
    """Admit `prompt` (expecting a cached prefix), prefill the rest,
    decode greedily: (cached_len, tokens, per-step logits of the slot)."""
    info = engine.admit_prompt(prompt)
    n = len(prompt) - info.cached_len
    tok = engine.prefill_chunk(info.slot, prompt, info.cached_len, n,
                               0.0, 0)
    toks, logs = [tok], []
    for _ in range(steps):
        t, _, lg = engine.step()
        lg = lg.float().numpy() if isinstance(lg, torch.Tensor) else lg
        toks.append(int(t[info.slot]))
        logs.append(np.asarray(lg[info.slot], np.float32))
    engine.release_slot(info.slot)
    return info.cached_len, toks, logs


def _prefill_and_retain(engine, prompt):
    info = engine.admit_prompt(prompt)
    engine.prefill(info.slot, prompt, 0.0, 0)
    engine.cache.register_prefix(info.slot, prompt)
    engine.release_slot(info.slot)


def test_spilled_promoted_and_imported_prefixes_decode_as_reference(nets):
    """The reference demotes and promotes its prefix; the port does the
    same; a second port engine imports the prefix from the port's export
    and a third from the REFERENCE's export (cross-package frames). All
    four decode the same tokens, logits within 2e-5."""
    jnet, pnet = nets
    prompt = np.arange(3, 20, dtype=np.int32)          # 2 pages + 1
    j = JaxDecodeEngine(jnet, _cfg(JaxDecodeConfig, spill_pages=8),
                        name="kvf-j")
    p = DecodeEngine(pnet, _cfg(DecodeConfig, spill_pages=8), name="kvf-p")
    try:
        runs = {}
        for name, eng in (("ref", j), ("port", p)):
            _prefill_and_retain(eng, prompt)
            _evict_all(eng.cache)
            assert len(eng.spill) == 2 and eng.cache.retained_pages() == 0
            runs[name] = _hit_then_steps(eng, prompt)
        assert p.fabric["demoted"] == 2 and p.fabric["landed"] == 2
        head = prompt[:16]
        exports = {"port": p.export_pages(head),
                   "ref": j.export_pages(head)}
        assert [len(f) for f in exports["port"]] \
            == [len(f) for f in exports["ref"]]
        for src, frames in exports.items():
            imp = DecodeEngine(pnet, _cfg(DecodeConfig),
                               name=f"kvf-imp-{src}")
            try:
                assert imp.import_pages(head, frames) == 2
                assert imp.import_pages(head, frames) == 0   # idempotent
                runs[f"import-{src}"] = _hit_then_steps(imp, prompt)
            finally:
                imp.close()
        ref_cached, ref_toks, ref_logs = runs.pop("ref")
        assert ref_cached == 16
        for name, (cached, toks, logs) in runs.items():
            assert cached == 16, name
            assert toks == ref_toks, name
            for a, b in zip(logs, ref_logs):
                np.testing.assert_allclose(a, b, rtol=0, atol=ATOL,
                                           err_msg=name)
        # a frame of another geometry is refused before any pool write
        with pytest.raises(pfab.FrameError, match="geometry"):
            k = torch.zeros((1, 8, 4, 8))
            dig = pfab.chain_digests([head[:8].tobytes()])[0]
            p._land_frame(1, pfab.pack_page(k, k, dig), dig)
    finally:
        j.close()
        p.close()


def test_warm_runs_the_fabric_programs(nets):
    _, pnet = nets
    eng = DecodeEngine(pnet, _cfg(DecodeConfig, spill_pages=4),
                       name="kvf-warm")
    try:
        eng.warm()
        assert {"kv_extract", "kv_land"} <= eng._programs
        _prefill_and_retain(eng, np.arange(1, 17, dtype=np.int32))
        _evict_all(eng.cache)
        _hit_then_steps(eng, np.arange(1, 17, dtype=np.int32), steps=1)
        eng.export_pages(np.arange(1, 17, dtype=np.int32))
        assert eng.request_path_first_runs == 0
    finally:
        eng.close()


# ---------------------------------------------- servables: the trio
ZOO_SRC = ("zoo:TransformerLM?vocab_size=48&n_layers=1&n_embd=32"
           "&n_heads=4&seq_length=32")


def _greedy(lm, prompt, n=6):
    req = lm.generate(prompt, max_new_tokens=n, temperature=0.0)
    toks = []
    while True:
        kind, payload = req.events.get(timeout=60)
        if kind == "token":
            toks.append(int(payload))
        elif kind == "error":
            raise payload
        else:
            return toks, payload


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return t.numpy()


@pytest.fixture(scope="module")
def trio():
    """The reference's spill servable and the port's spill and importer
    servables, on the same weights (the port net's params moved into the
    reference's)."""
    from deeplearning4j_tpu.serving.registry import (
        load_servable as jax_load,
    )
    from deeplearning4j_tpu_torch.serving.registry import load_servable
    pnet = load_servable(ZOO_SRC, device="cpu")
    jnet = jax_load(ZOO_SRC)
    jnet.params = _np_tree(pnet.params)
    spill = DecodeConfig(slots=2, page_size=8, pool_pages=8, spill_pages=8,
                         prefill_buckets=BUCKETS)
    imp = DecodeConfig(slots=2, page_size=8, spill_pages=4,
                       prefill_buckets=BUCKETS)
    lms = {"port": ServedLM("kvf-spill", pnet, ZOO_SRC, decode=spill),
           "port_imp": ServedLM("kvf-imp", pnet, ZOO_SRC, decode=imp),
           "ref": JaxServedLM("kvf-ref", jnet, ZOO_SRC,
                              decode=JaxDecodeConfig(
                                  slots=2, page_size=8, pool_pages=8,
                                  spill_pages=8, prefill_buckets=BUCKETS))}
    yield lms
    for lm in lms.values():
        lm.shutdown(drain=False, timeout=5)


def test_greedy_parity_local_spill_and_remote(trio):
    """The reference's acceptance test on the port: local prefill,
    promote-on-hit from the spill tier and pages shipped through
    export -> import give the same greedy tokens — and the reference's
    servable gives them too."""
    prompt = list(range(1, 17))
    other = list(range(30, 46))
    port, imp, ref = trio["port"], trio["port_imp"], trio["ref"]
    local, d0 = _greedy(port, prompt)
    assert d0["cached_tokens"] == 0
    assert _greedy(ref, prompt)[0] == local
    eng = port.scheduler.admitting_engine()
    dem0 = eng.fabric["demoted"]
    for fill in (other, [5, 6] + other[2:], [9, 8] + other[2:]):
        _greedy(port, fill)
        _greedy(ref, fill)
    assert eng.fabric["demoted"] > dem0
    prom0 = eng.cache.spill_stats["promotions"]
    hot, d1 = _greedy(port, prompt)
    assert hot == local and d1["cached_tokens"] > 0
    assert eng.cache.spill_stats["promotions"] > prom0
    ref_hot, ref_d1 = _greedy(ref, prompt)
    assert ref_hot == local
    assert ref_d1["cached_tokens"] == d1["cached_tokens"]
    blob = port.export_prefix(prompt)
    assert pfab.unpack_transfer(blob)[2]["n_frames"] == 2
    res = imp.import_prefix(blob)
    assert res["adopted"] == 2 and res["tokens"] == 16
    remote, d2 = _greedy(imp, prompt)
    assert remote == local and d2["cached_tokens"] >= 8
    assert imp.import_prefix(blob)["adopted"] == 0
    # the reference's export lands in the port, the port's in the
    # reference
    assert imp.import_prefix(ref.export_prefix(prompt))["adopted"] == 0
    assert ref.import_prefix(blob)["adopted"] == 0


def test_import_corrupt_payload_is_a_clean_error(trio):
    imp = trio["port_imp"]
    blob = imp.export_prefix(list(range(1, 17)))
    for cut in (blob[:25], b"junk" + blob[4:]):
        with pytest.raises(pfab.FrameError):
            imp.import_prefix(cut)
    bad = bytearray(blob)
    bad[-40] ^= 0xFF
    with pytest.raises(pfab.FrameError):
        imp.import_prefix(bytes(bad))
    with pytest.raises(ValueError):
        imp.export_prefix([1, 2, 3])
    toks, _ = _greedy(imp, [7, 7, 7])
    assert len(toks) == 6


def test_fabric_jobs_propagate_errors_without_killing_scheduler(trio):
    port = trio["port"]

    class Boom(RuntimeError):
        pass

    def job(engine):
        raise Boom("fabric job failed")

    with pytest.raises(Boom):
        port.scheduler.run_fabric(job)
    assert port.scheduler.run_fabric(lambda eng: eng.cfg.page_size) == 8
    for lm in (trio["port"], trio["port_imp"]):
        assert lm.scheduler.admitting_engine().request_path_first_runs == 0


def test_run_fabric_rejects_when_draining(nets):
    _, pnet = nets
    lm = ServedLM("kvf-drain", pnet, "zip",
                  decode=DecodeConfig(slots=2, page_size=8,
                                      prefill_buckets=BUCKETS))
    lm.shutdown(drain=False, timeout=5)
    with pytest.raises(ServerDrainingError):
        lm.scheduler.run_fabric(lambda eng: None)
    with pytest.raises(ServerDrainingError):
        lm.export_prefix(list(range(8)))
