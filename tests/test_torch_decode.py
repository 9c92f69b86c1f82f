"""The port's decode engine (serving/decode.py) against the JAX package's,
on one set of weights: a tiny TransformerLM (vocab 32, context 32, 2
layers, n_embd 32, 4 heads) built in JAX with its weights perturbed off
their init values, moved across through the checkpoint zip.

Tolerances: f32 logits atol 2e-5 (two layers of f32 matmuls, layer norms
and softmaxes summed in other orders by XLA and torch; observed ~1e-6);
int8 1e-4 (the same, through the int8 weights both sides quantize
bitwise alike); bf16 5e-2 (XLA fuses bf16 elementwise chains in f32 and
rounds once, torch rounds after each op; a logit of magnitude ~2 has a
bf16 step of 1/64). Sampling is held by distribution, never token by
token: the JAX and torch random streams differ.
"""
import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import (
    TransformerLM as JaxLM, TransformerLMMoE as JaxLMMoE,
)
from deeplearning4j_tpu.serving.decode import (
    DecodeConfig as JaxDecodeConfig, DecodeEngine as JaxDecodeEngine,
)
from deeplearning4j_tpu.util.serialization import save_model as jax_save
from deeplearning4j_tpu_torch.serving import kvcache
from deeplearning4j_tpu_torch.serving.decode import (
    TOP_K_MAX, DecodeConfig, DecodeEngine, apply_variant,
)
from deeplearning4j_tpu_torch.serving.registry import ModelLoadError
from deeplearning4j_tpu_torch.util.serialization import load_model

LM = dict(vocab_size=32, seq_length=32, n_layers=2, n_embd=32, n_heads=4,
          mlp_ratio=2, seed=7)
ATOL = 2e-5
BUCKETS = (8, 32)


def _jax_net(cls, seed):
    net = cls(**LM).init()
    rs = np.random.RandomState(seed)
    net.params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rs.randn(*a.shape).astype("float32"),
        net.params)
    return net


def _pair(cls, tmp_path_factory, seed):
    jnet = _jax_net(cls, seed)
    path = str(tmp_path_factory.mktemp("lm") / "lm.zip")
    jax_save(jnet, path)
    return jnet, load_model(path, device="cpu")


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(JAX net, port net) with the same weights."""
    return _pair(JaxLM, tmp_path_factory, 0)


def _engines(nets, **kw):
    jnet, pnet = nets
    j = JaxDecodeEngine(jnet, JaxDecodeConfig(
        slots=2, page_size=8, prefill_buckets=BUCKETS, **kw), name="j")
    p = DecodeEngine(pnet, DecodeConfig(
        slots=2, page_size=8, prefill_buckets=BUCKETS, **kw), name="p")
    return j, p


@pytest.fixture(scope="module")
def f32_engines(nets):
    return _engines(nets)


def _prefill_both(engines, prompt):
    j, p = engines
    js, ps = j.cache.admit(len(prompt)), p.cache.admit(len(prompt))
    assert js == ps
    jt, jl = j.prefill(js, prompt, 0.0, 0)
    pt, pl = p.prefill(ps, prompt, 0.0, 0)
    return ps, (jt, jl), (pt, pl.float().numpy())


def test_prefill_logits_match_reference_and_full_recompute(f32_engines):
    j, p = f32_engines
    prompt = np.array([5, 2, 8, 1, 30, 17, 4, 9, 11], np.int32)   # 2 pages
    slot, (jt, jl), (pt, pl) = _prefill_both(f32_engines, prompt)
    try:
        np.testing.assert_allclose(pl, jl, rtol=0, atol=ATOL)
        full = p.logits_full(prompt[None])[0, -1]
        np.testing.assert_allclose(pl, full, rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            p.logits_full(prompt[None]), j.logits_full(prompt[None]),
            rtol=0, atol=ATOL)
        assert pt == jt == int(np.argmax(jl))
    finally:
        j.cache.release(slot)
        p.cache.release(slot)


def test_24_greedy_steps_match_reference(f32_engines):
    """Two slots decode side by side: the same 24 greedy tokens as the
    JAX engine, with per-step logits within 2e-5 of its and of the
    port's own full recompute; the sequences cross page boundaries."""
    j, p = f32_engines
    prompts = [np.array([5, 2, 8, 1], np.int32),
               np.array([3, 14, 15, 9, 26, 5, 3], np.int32)]
    slots, seqs = [], []
    for prompt in prompts:
        slot, (jt, _), (pt, _) = _prefill_both(f32_engines, prompt)
        assert pt == jt
        slots.append(slot)
        seqs.append(list(prompt) + [pt])
    try:
        pages0 = p.cache.describe()["pages_used"]
        for _ in range(24):
            jtoks, jact, jlog = j.step()
            ptoks, pact, plog = p.step()
            plog = plog.numpy()
            assert (jact == pact).all()
            for slot, seq in zip(slots, seqs):
                assert pact[slot]
                np.testing.assert_allclose(plog[slot], jlog[slot], rtol=0,
                                           atol=ATOL)
                full = p.logits_full(np.array([seq]))[0, -1]
                np.testing.assert_allclose(plog[slot], full, rtol=0,
                                           atol=ATOL)
                assert int(ptoks[slot]) == int(jtoks[slot])
                seq.append(int(ptoks[slot]))
        assert len(seqs[0]) == 4 + 1 + 24
        assert p.cache.describe()["pages_used"] > pages0
        np.testing.assert_array_equal(p.cache.seq_lens, j.cache.seq_lens)
        np.testing.assert_array_equal(p.cache.page_table, j.cache.page_table)
    finally:
        for slot in slots:
            j.cache.release(slot)
            p.cache.release(slot)


def _greedy(engine, prompt, n, budget=0):
    """n greedy tokens through the scheduler's prefill logic: admit (the
    prefix cache may map pages), the dense program for a cold prompt
    within budget, budgeted chunks otherwise, then n - 1 steps. Returns
    (tokens, cached_len, chunks)."""
    prompt = np.asarray(prompt, np.int32)
    info = engine.admit_prompt(prompt)
    slot, pos, chunks = info.slot, info.cached_len, 0
    try:
        while pos < len(prompt):
            step = len(prompt) - pos if budget <= 0 \
                else min(budget, len(prompt) - pos)
            if pos == 0 and step == len(prompt):
                tok, _ = engine.prefill(slot, prompt, 0.0, 0)
            else:
                tok = engine.prefill_chunk(slot, prompt, pos, step, 0.0, 0)
            pos += step
            chunks += 1
        engine.cache.register_prefix(slot, prompt)
        out = [int(tok)]
        for _ in range(n - 1):
            toks, act, _ = engine.step()
            assert act[slot]
            out.append(int(toks[slot]))
        return out, info.cached_len, chunks
    finally:
        engine.release_slot(slot)


def test_prefix_cache_and_chunked_prefill_keep_greedy_tokens(nets):
    """Cold, hot (shared prefix), COW (page-aligned fully cached prompt)
    and chunked prefill all give the plain path's greedy tokens — which
    are the JAX engine's."""
    j, plain = _engines(nets, prefix_cache=False)
    cached = DecodeEngine(nets[1], DecodeConfig(
        slots=2, page_size=8, prefill_buckets=BUCKETS), name="cached")
    chunked = DecodeEngine(nets[1], DecodeConfig(
        slots=2, page_size=8, prefill_buckets=BUCKETS, prefix_cache=False,
        prefill_chunk_tokens=8), name="chunked")
    prefix = list(range(3, 19))                       # 2 full pages
    for prompt, want_cached in ((prefix + [1, 2, 3], 0),   # cold
                                (prefix + [20, 21], 16),   # hot
                                (prefix, 15)):              # COW
        ref = [int(t) for t in _jax_greedy(j, prompt, 6)]
        assert _greedy(plain, prompt, 6)[0] == ref
        toks, got_cached, _ = _greedy(cached, prompt, 6)
        assert toks == ref and got_cached == want_cached, prompt
        toks, _, chunks = _greedy(chunked, prompt, 6, budget=8)
        assert toks == ref and chunks == -(-len(prompt) // 8)
    # the COW copy wrote a private page; the shared source is untouched
    assert cached.cache.stats == {"hits": 2, "misses": 1, "evictions": 0,
                                  "page_stalls": 0}


def _jax_greedy(engine, prompt, n):
    prompt = np.asarray(prompt, np.int32)
    slot = engine.cache.admit(len(prompt))
    try:
        tok, _ = engine.prefill(slot, prompt, 0.0, 0)
        out = [tok]
        for _ in range(n - 1):
            toks, _, _ = engine.step()
            out.append(int(toks[slot]))
        return out
    finally:
        engine.cache.release(slot)


def test_moe_lm_matches_reference(tmp_path_factory):
    jnet, pnet = _pair(JaxLMMoE, tmp_path_factory, 3)
    j, p = _engines((jnet, pnet))
    prompt = np.array([7, 1, 30, 2, 2, 19], np.int32)
    slot, (jt, jl), (pt, pl) = _prefill_both((j, p), prompt)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=ATOL)
    assert pt == jt
    for _ in range(6):
        jtoks, _, jlog = j.step()
        ptoks, _, plog = p.step()
        np.testing.assert_allclose(plog.numpy()[slot], jlog[slot], rtol=0,
                                   atol=ATOL)
        assert int(ptoks[slot]) == int(jtoks[slot])


@pytest.mark.parametrize("mode,atol", [("int8", 1e-4), ("bf16", 5e-2)])
def test_quantized_engines_match_reference(nets, mode, atol):
    j, p = _engines(nets, quantize=mode)
    assert p._kpool.dtype == (torch.bfloat16 if mode == "bf16"
                              else torch.float32)
    prompt = np.array([4, 4, 12, 31, 0, 9, 8, 2, 6, 1], np.int32)
    slot, (jt, jl), (pt, pl) = _prefill_both((j, p), prompt)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=atol)
    for _ in range(4):
        jtoks, _, jlog = j.step()
        ptoks, _, plog = p.step()
        np.testing.assert_allclose(plog.float().numpy()[slot], jlog[slot],
                                   rtol=0, atol=atol)
    toks = np.random.RandomState(1).randint(0, 32, (2, 12))
    np.testing.assert_allclose(p.logits_full(toks), j.logits_full(toks),
                               rtol=0, atol=atol)


def test_variants_and_load_errors(nets):
    cfg = DecodeConfig()
    assert apply_variant(cfg, "int8").quantize == "int8"
    assert apply_variant(cfg, None) is cfg
    spec = apply_variant(cfg, "spec:k=4")
    assert spec.spec_draft == "int8" and spec.spec_k == 4
    with pytest.raises(ValueError, match="key=value"):
        apply_variant(cfg, "spec:k4")
    with pytest.raises(ValueError):
        apply_variant(cfg, "fp4")
    with pytest.raises(ModelLoadError, match="page_size"):
        DecodeEngine(nets[1], DecodeConfig(page_size=5))
    with pytest.raises(ModelLoadError, match="prefill bucket"):
        DecodeEngine(nets[1], DecodeConfig(page_size=8,
                                           prefill_buckets=(12,)))


def _topk_softmax(logits, temp, k):
    kth = np.sort(logits)[-k]
    z = np.where(logits >= kth, logits / temp, -np.inf)
    p = np.exp(z - z.max())
    return p / p.sum()


def test_sampling_distribution_topk_set_and_seed(f32_engines, nets):
    """16384 draws from one logits vector: their frequencies are within
    total-variation distance 0.02 of softmax(logits / T) over the top-k;
    every draw lies in the top-k set; greedy rows take the first argmax;
    one seed gives one stream."""
    _, p = f32_engines
    rs = np.random.RandomState(11)
    logits = rs.randn(32).astype(np.float32) * 2
    n, temp, k = 16384, 0.8, 8
    lg = torch.from_numpy(np.tile(logits, (n, 1)))
    temps = torch.full((n,), temp)
    topks = torch.full((n,), k, dtype=torch.int64)
    draws = p._sample(lg, temps, topks, counter=5).numpy()
    freq = np.bincount(draws, minlength=32) / n
    want = _topk_softmax(logits.astype(np.float64), temp, k)
    assert 0.5 * np.abs(freq - want).sum() < 0.02
    top = set(np.argsort(logits)[-k:].tolist())
    assert set(draws.tolist()) <= top
    # the same counter draws the same noise; another counter does not
    again = p._sample(lg, temps, topks, counter=5).numpy()
    np.testing.assert_array_equal(draws, again)
    assert (p._sample(lg, temps, topks, counter=6).numpy() != draws).any()
    # k <= 0 samples the whole vocabulary; k above TOP_K_MAX is clipped
    wide = p._sample(lg[:2048], temps[:2048],
                     torch.zeros(2048, dtype=torch.int64), 1).numpy()
    assert len(set(wide.tolist())) > k
    assert TOP_K_MAX == 64
    # greedy rows: argmax, the first of tied maxima
    tied = torch.tensor([[1.0, 3.0, 3.0, 0.0]])
    assert int(p._sample(tied, torch.zeros(1), torch.zeros(1, dtype=torch
                                                              .int64),
                         0)[0]) == 1
    assert int(p._sample(tied, None, None, 0)[0]) == 1
    # two engines with one seed sample the same tokens, step by step
    runs = []
    for _ in range(2):
        eng = DecodeEngine(nets[1], DecodeConfig(
            slots=2, page_size=8, prefill_buckets=BUCKETS, seed=3))
        slot = eng.cache.admit(3)
        tok, _ = eng.prefill(slot, np.array([1, 2, 3]), 1.2, 5)
        out = [tok] + [int(eng.step()[0][slot]) for _ in range(8)]
        runs.append(out)
    assert runs[0] == runs[1]


def test_inactive_and_excluded_slots_leave_live_pages_unchanged(nets):
    """Inactive slots write their garbage rows to the dump page, and an
    excluded (mid-prefill) slot writes nothing live: a step changes only
    the active slot's new position and page 0."""
    eng = DecodeEngine(nets[1], DecodeConfig(
        slots=3, page_size=8, prefill_buckets=BUCKETS), name="dump")
    a = eng.cache.admit(5)
    b = eng.cache.admit(11)
    eng.prefill(a, np.array([1, 2, 3, 4, 5]), 0.0, 0)
    eng.prefill(b, np.arange(11) % 32, 0.0, 0)
    k0, v0 = eng._kpool.clone(), eng._vpool.clone()
    pos = int(eng.cache.seq_lens[a])
    page, off = int(eng.cache.page_table[a, pos // 8]), pos % 8
    toks, act, _ = eng.step(exclude=[b])
    assert act.tolist() == [True if s == a else False for s in range(3)]
    changed = (eng._kpool != k0).any(dim=(0, 3, 4))   # (page, offset)
    changed[kvcache.DUMP_PAGE] = False
    assert changed.nonzero().tolist() == [[page, off]]
    assert torch.equal(eng._vpool[:, 1:page], v0[:, 1:page])
    assert torch.equal(eng._vpool[:, page + 1:], v0[:, page + 1:])
    # every slot inactive: nothing but the dump page moves
    eng.release_slot(a)
    eng.release_slot(b)
    k1 = eng._kpool.clone()
    eng.step()
    assert torch.equal(eng._kpool[:, 1:], k1[:, 1:])
