"""The port's speculative decoding (serving/decode.py: the draft engine,
the propose and verify programs, host acceptance, the scheduler's spec
branch) against the JAX package's.

- The verify is k+1 unrolled one-token step bodies: its (S, k+1, V)
  logits are BITWISE those of k+1 sequential `step()` calls of the port
  across a KV page boundary, and within 2e-5 of the reference's verify on
  the same weights (2-layer, width-32, vocab-64 LM through the zip; f32
  sums in other orders, observed ~1e-6).
- Greedy ``@spec:draft=int8,k=4`` streams equal plain decode token for
  token, with the prefix cache on and off.
- `_spec_dist` and `_spec_accept` give exactly the reference's
  distributions and (accepted, token) decisions on the same logits with
  the same seed: the host sampler is the reference's numpy stream.
- A draft that disagrees trips the acceptance floor and the output stays
  exact; another vocabulary and spec_k < 1 are refused at build; no
  program first runs on the request path.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.serving.decode import (
    DecodeConfig as JaxDecodeConfig, DecodeEngine as JaxDecodeEngine,
    apply_variant as jax_apply_variant,
)
from deeplearning4j_tpu.util.serialization import save_model as jax_save
from deeplearning4j_tpu_torch.serving.decode import (
    DecodeConfig, DecodeEngine, ServedLM, apply_variant,
)
from deeplearning4j_tpu_torch.serving.quantize import (
    is_spec_variant, parse_variant,
)
from deeplearning4j_tpu_torch.serving.registry import (
    ModelLoadError, load_servable,
)
from deeplearning4j_tpu_torch.util.serialization import load_model

LM = dict(vocab_size=64, seq_length=32, n_layers=2, n_embd=32, n_heads=4,
          mlp_ratio=2, seed=13)
BUCKETS = (8, 32)
ATOL = 2e-5
ZOO_SRC = ("zoo:TransformerLM?vocab_size=64&n_layers=2&n_embd=32"
           "&n_heads=4&seq_length=32")
#: same arch, different init: a same-vocab draft that rarely agrees
DRAFT_SRC = ZOO_SRC + "&seed=99"


def _tokens(req, timeout=60.0):
    toks = []
    deadline = time.monotonic() + timeout
    while True:
        ev = req.events.get(timeout=max(0.1, deadline - time.monotonic()))
        if ev[0] == "token":
            toks.append(int(ev[1]))
        elif ev[0] == "done":
            return toks, ev[1]
        else:
            raise ev[1]


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(JAX net, port net) with the same weights, perturbed off init."""
    jnet = JaxLM(**LM).init()
    rs = np.random.RandomState(2)
    jnet.params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rs.randn(*a.shape).astype("float32"),
        jnet.params)
    path = str(tmp_path_factory.mktemp("spec") / "lm.zip")
    jax_save(jnet, path)
    return jnet, load_model(path, device="cpu")


# ------------------------------------------------------- variant grammar
@pytest.mark.parametrize("variant", [
    "spec", "spec:k=2", "spec:draft=bf16,k=2,floor=0.6,window=3,"
    "pool_pages=9", f"spec:draft={DRAFT_SRC}", "int8"])
def test_apply_variant_matches_reference(variant):
    port = apply_variant(DecodeConfig(slots=2, page_size=8), variant)
    ref = jax_apply_variant(JaxDecodeConfig(slots=2, page_size=8), variant)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_spec_variant_grammar_and_errors():
    assert parse_variant("zoo:X@spec:draft=zoo:Y@int8,k=4") == \
        ("zoo:X", "spec:draft=zoo:Y@int8,k=4")
    assert is_spec_variant("spec:k=4") and not is_spec_variant("int8")
    cfg = DecodeConfig()
    with pytest.raises(ValueError, match="key=value"):
        apply_variant(cfg, "spec:k4")
    with pytest.raises(ValueError, match="unknown @spec option"):
        apply_variant(cfg, "spec:bogus=1")
    with pytest.raises(ValueError, match="unknown servable variant"):
        apply_variant(cfg, "fp4")


# ------------------------------------------- the verify: bitwise oracle
def test_verify_bitwise_equals_sequential_steps_and_the_reference(nets):
    """One k-drafted verify == k+1 sequential decode steps of the port,
    bitwise per position, the burst crossing a page boundary (prompt 6 +
    4 rows over page_size 8); and within 2e-5 of the reference's
    verify."""
    jnet, pnet = nets
    cfg = dict(slots=2, page_size=8, prefill_buckets=BUCKETS)
    a = DecodeEngine(pnet, DecodeConfig(**cfg), name="vo-seq")
    b = DecodeEngine(pnet, DecodeConfig(**cfg), name="vo-fused")
    jb = JaxDecodeEngine(jnet, JaxDecodeConfig(**cfg), name="vo-ref")
    try:
        prompt = np.array([1, 2, 3, 4, 5, 6], np.int32)
        k = 3
        sa, sb, sj = (e.cache.admit(len(prompt)) for e in (a, b, jb))
        t0 = a.prefill(sa, prompt, 0.0, 0)[0]
        assert b.prefill(sb, prompt, 0.0, 0)[0] == t0
        assert jb.prefill(sj, prompt, 0.0, 0)[0] == t0
        seq_logits, toks = [], [t0]
        for _ in range(k + 1):
            tk, act, lg = a.step()
            assert act[sa]
            seq_logits.append(lg[sa].clone())
            toks.append(int(tk[sa]))
        for e, s in ((b, sb), (jb, sj)):
            assert e.cache.ensure_capacity(s, k + 1)
            assert (e.cache.page_table[s, :2] > 0).all()
        drafted = np.zeros((2, k), np.int32)
        drafted[sb] = toks[1:k + 1]
        act = np.zeros((2,), bool)
        act[sb] = True
        with torch.no_grad():
            vlog = b._verify(b._last_tokens, act,
                             torch.from_numpy(drafted.astype(np.int64)),
                             np.arange(2, dtype=np.int64))
        assert tuple(vlog.shape) == (2, k + 1, 64)
        for i in range(k + 1):
            assert torch.equal(vlog[sb, i], seq_logits[i]), \
                f"verify position {i} is not bitwise the {i + 1}-th step"
        _, _, jlog = jax.jit(jb._verify_fn)(
            jb._params, jb._kpool, jb._vpool,
            np.asarray(jb.cache.page_table), np.asarray(jb.cache.seq_lens),
            jb._last_tokens.copy(), drafted, act)
        np.testing.assert_allclose(vlog[sb].numpy(),
                                   np.asarray(jlog, np.float32)[sj],
                                   rtol=0, atol=ATOL)
    finally:
        a.close()
        b.close()
        jb.close()


# ------------------------------------------ host acceptance, exactly
@pytest.fixture(scope="module")
def accept_pair(nets):
    jnet, pnet = nets
    cfg = dict(slots=1, page_size=8, prefill_buckets=BUCKETS, seed=7)
    j = JaxDecodeEngine(jnet, JaxDecodeConfig(**cfg), name="acc-ref")
    p = DecodeEngine(pnet, DecodeConfig(**cfg), name="acc-port")
    yield j, p
    j.close()
    p.close()


def test_spec_dist_equals_reference_with_the_topk_clip(accept_pair):
    j, p = accept_pair
    rs = np.random.RandomState(3)
    for temp, topk in ((1.0, 4), (0.7, 0), (1.3, 80), (0.5, 1)):
        lg = rs.randn(64).astype(np.float32)
        got, want = p._spec_dist(lg, temp, topk), j._spec_dist(lg, temp,
                                                               topk)
        assert np.array_equal(got, want)
    p4 = p._spec_dist(np.arange(16, dtype=np.float32), 1.0, 4)
    assert np.all(p4[:-4] == 0.0) and abs(p4.sum() - 1.0) < 1e-12


def test_spec_accept_decisions_equal_the_reference(accept_pair):
    """The same logits through both packages' acceptance, call after
    call (the host streams advance alike): greedy prefix match, p == q
    (always accepts), a forced rejection with a one-hot residual, the
    top-k clip, and random sampled rounds give equal (a, token)."""
    j, p = accept_pair
    # one seed, one stream: the reference's (seed ^ 0x5EC5) numpy state
    assert np.array_equal(p._spec_rng.get_state()[1],
                          j._spec_rng.get_state()[1])
    v, k = 16, 4
    rs = np.random.RandomState(4)
    cases = []
    vlog = np.full((k + 1, v), -5.0, np.float32)
    vlog[np.arange(k + 1), [4, 7, 2, 6, 1]] = 5.0
    cases += [(np.array([4, 7, 1, 3]), vlog, vlog[:k], 0.0, 0),
              (np.array([4, 7, 2, 6]), vlog, vlog[:k], 0.0, 0)]
    same = rs.randn(k + 1, v).astype(np.float32)
    cases += [(np.array([3, 9, 14, 2]), same, same[:k], 0.7, 0)] * 3
    q1 = np.full((k, v), -1e9, np.float32)
    q1[:, 1] = 0.0
    p2 = np.full((k + 1, v), -1e9, np.float32)
    p2[:, 2] = 0.0
    cases.append((np.array([1, 1, 1, 1]), p2, q1, 1.0, 0))
    for _ in range(40):
        vl = rs.randn(k + 1, v).astype(np.float32)
        ql = vl[:k] + 0.7 * rs.randn(k, v).astype(np.float32)
        drafted = np.array([rs.randint(v) for _ in range(k)])
        cases.append((drafted, vl, ql, float(rs.choice([0.5, 1.0, 1.5])),
                      int(rs.choice([0, 3, 8]))))
    got = [p._spec_accept(*c) for c in cases]
    want = [j._spec_accept(*c) for c in cases]
    assert got == want
    assert got[0] == (2, 2) and got[1] == (4, 1)
    assert all(g[0] == k for g in got[2:5])
    assert got[5] == (0, 2)
    assert len({g for g in got[6:]}) > 5          # the random rounds vary


# ------------------------------------------------ greedy spec parity
@pytest.fixture(scope="module")
def spec_pair():
    cfg = DecodeConfig(slots=2, page_size=8, prefill_buckets=BUCKETS)
    net = load_servable(ZOO_SRC, device="cpu")
    plain = ServedLM("spec-plain", net, ZOO_SRC, decode=cfg)
    spec = ServedLM("spec-on", net, ZOO_SRC,
                    decode=apply_variant(cfg, "spec:draft=int8,k=4"))
    yield plain, spec
    plain.shutdown(drain=False, timeout=5)
    spec.shutdown(drain=False, timeout=5)


def test_greedy_spec_parity_cache_on(spec_pair):
    plain, spec = spec_pair
    eng = spec.scheduler.admitting_engine()
    assert eng.spec_enabled and eng.describe()["spec"]["k"] == 4
    for prompt in ([1, 2, 3], [7, 8, 9, 10], [5] * 6, [1, 2, 3],
                   list(range(3, 20))):
        pt, _ = _tokens(plain.generate(prompt, max_new_tokens=12))
        st, info = _tokens(spec.generate(prompt, max_new_tokens=12))
        assert pt == st, "speculation changed a greedy stream"
        assert info["spec_rounds"] > 0 and info["spec_proposed"] > 0
        assert 0 <= info["spec_accepted"] <= info["spec_proposed"]
    stats = eng.spec_stats
    assert stats["host_syncs"] == stats["rounds"] > 0


def test_greedy_spec_parity_cache_off():
    cfg = DecodeConfig(slots=2, page_size=8, prefill_buckets=BUCKETS,
                       prefix_cache=False)
    net = load_servable(ZOO_SRC, device="cpu")
    plain = ServedLM("spec-plain-nc", net, ZOO_SRC, decode=cfg)
    spec = ServedLM("spec-on-nc", net, ZOO_SRC,
                    decode=apply_variant(cfg, "spec:draft=int8,k=4"))
    try:
        for prompt in ([4, 5, 6], [11] * 5):
            pt, _ = _tokens(plain.generate(prompt, max_new_tokens=26))
            st, info = _tokens(spec.generate(prompt, max_new_tokens=26))
            assert len(st) >= 24 and pt == st
            assert info["spec_proposed"] > 0
    finally:
        plain.shutdown(drain=False, timeout=5)
        spec.shutdown(drain=False, timeout=5)


def test_temperature_spec_stream_completes(spec_pair):
    _, spec = spec_pair
    toks, info = _tokens(spec.generate([2, 4, 6], max_new_tokens=20,
                                       temperature=0.9, top_k=8))
    assert len(toks) == 20 and all(0 <= t < 64 for t in toks)
    assert info["spec_rounds"] > 0
    assert 0 <= info["spec_accepted"] <= info["spec_proposed"]


def test_low_acceptance_trips_floor_and_output_is_still_exact(spec_pair):
    plain, _ = spec_pair
    cfg = DecodeConfig(slots=2, page_size=8, prefill_buckets=BUCKETS)
    bad = ServedLM(
        "spec-fb", load_servable(ZOO_SRC, device="cpu"), ZOO_SRC,
        decode=apply_variant(
            cfg, f"spec:draft={DRAFT_SRC},k=4,floor=0.9,window=2"))
    try:
        prompt = [3, 1, 4, 1, 5]
        pt, _ = _tokens(plain.generate(prompt, max_new_tokens=26))
        st, _ = _tokens(bad.generate(prompt, max_new_tokens=26))
        assert pt == st, "the fallback path changed the stream"
        eng = bad.scheduler.admitting_engine()
        assert eng.spec_stats["fallbacks"].get("acceptance_floor", 0) >= 1
    finally:
        bad.shutdown(drain=False, timeout=5)


# --------------------------------------------------- loud build failures
def test_vocab_mismatched_draft_and_bad_k_rejected_at_build():
    net = load_servable(ZOO_SRC, device="cpu")
    other = ZOO_SRC.replace("vocab_size=64", "vocab_size=32")
    cfg = apply_variant(DecodeConfig(slots=1, page_size=8),
                        f"spec:draft={other}")
    with pytest.raises(ModelLoadError, match="vocab"):
        DecodeEngine(net, cfg, name="vmm")
    cfg = apply_variant(DecodeConfig(slots=1, page_size=8), "spec:k=0")
    with pytest.raises(ModelLoadError, match="spec_k"):
        DecodeEngine(net, cfg, name="k0")


def test_spec_traffic_never_first_runs_on_request_path(spec_pair):
    """After the greedy and sampled speculative traffic above, neither
    the target nor its draft ran a program first for a live request:
    warm() covered draft_k (greedy and sampling) and verify_(k+1)."""
    _, spec = spec_pair
    eng = spec.scheduler.admitting_engine()
    assert eng.request_path_first_runs == 0
    assert eng.draft.request_path_first_runs == 0
    assert {"verify_5"} <= eng._programs
    assert {"draft_4", "draft_4_sampling"} <= eng.draft._programs
