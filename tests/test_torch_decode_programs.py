"""The decode engine's programs as functions of tensor operands
(serving/decode.py): the form a CUDA graph captures and replays, run
eagerly here on the CPU.

(a) Each program over the static operand buffers gives bitwise what the
    engine computed when its operands were host ints and arrays: the
    host-int forms are written out below as they stood (`_host_*`), over
    the engine's own layer helpers. Greedy tokens stay the JAX engine's.
(b) Each program body runs on `meta` parameters, pools and operands, where
    any read of a value on the host (`.item()`, `bool(t)`, `nonzero`, an
    int taken from a tensor) raises: nothing in a body would break a
    capture or freeze one value into every replay.
(c) The sampling noise is a pure function of (seed, counter, element):
    equal for equal inputs, different across counters and seeds, and
    Gumbel(0, 1) by a Kolmogorov-Smirnov bound.

Tolerances: bitwise for (a) (the same PyTorch ops on the same values);
(c)'s KS distance below 1.63 / sqrt(n), the 1 % critical value.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models.transformer import TransformerLM as JaxLM
from deeplearning4j_tpu.serving.decode import (
    DecodeConfig as JaxDecodeConfig, DecodeEngine as JaxDecodeEngine,
)
from deeplearning4j_tpu.util.serialization import save_model as jax_save
from deeplearning4j_tpu_torch.nn.layers.attention import (
    _merge_heads, dot_product_attention, rope,
)
from deeplearning4j_tpu_torch.serving import kvcache
from deeplearning4j_tpu_torch.serving.decode import (
    DecodeConfig, DecodeEngine, _LN, gumbel_noise,
)
from deeplearning4j_tpu_torch.serving.quantize import QTensor, qdot, qtake
from deeplearning4j_tpu_torch.util.serialization import load_model

LM = dict(vocab_size=32, seq_length=32, n_layers=2, n_embd=32, n_heads=4,
          mlp_ratio=2, seed=7)
BUCKETS = (8, 32)
K = 3


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(JAX net, port net) with the same weights, perturbed off init."""
    jnet = JaxLM(**LM).init()
    rs = np.random.RandomState(3)
    jnet.params = jax.tree_util.tree_map(
        lambda a: a + 0.1 * rs.randn(*a.shape).astype("float32"),
        jnet.params)
    path = str(tmp_path_factory.mktemp("lm") / "lm.zip")
    jax_save(jnet, path)
    return jnet, load_model(path, device="cpu")


def _engine(net, name, **kw):
    return DecodeEngine(net, DecodeConfig(slots=2, page_size=8,
                                          prefill_buckets=BUCKETS, **kw),
                        name=name)


@pytest.fixture
def twins(nets):
    """Two engines over one network: one runs the programs, the other the
    host-int forms; both start from zero pools."""
    a, b = _engine(nets[1], "prog"), _engine(nets[1], "host")
    yield a, b
    a.close()
    b.close()


# --------------------------------- the host-int forms, as they stood
def _host_prefill(e, tokens, length, page_row):
    tb = tokens.shape[0]
    toks = torch.from_numpy(tokens)[None]
    mask = (torch.arange(tb)[None] < length).to(torch.float32)
    logits, kvs = e._forward_tokens(e._params, toks, mask)
    for li, (k, v) in enumerate(kvs):
        kvcache.write_prompt_kv(e._kpool, e._vpool, li, k[0], v[0],
                                torch.from_numpy(page_row), e.cfg.page_size)
    last = logits[0, length - 1]
    return torch.argmax(last), last


def _host_block_chunk(e, conf, p, li, x, page_row, pos, phys, start, mask):
    h, _ = _LN.apply(p["ln1"], {}, x)
    q, k, v = e._qkv(conf, p, h)
    if conf.use_rope:
        q = rope(q, pos[None])
        k = rope(k, pos[None])
    kvcache.write_chunk_kv(e._kpool, e._vpool, li, k[0], v[0], phys,
                           pos % e.cfg.page_size)
    keys, vals = kvcache.gather_kv(e._kpool, e._vpool, li, page_row[None],
                                   e.max_context)
    out = dot_product_attention(q, keys, vals, mask=None, causal=True,
                                q_offset=start)
    y = qdot(_merge_heads(out), p["attn"]["Wo"])
    y = e._mlp(conf, p, x + y * mask[..., None].to(y.dtype))
    return y * mask[..., None].to(y.dtype)


def _host_chunk(e, tokens, start, end, page_row):
    tb = tokens.shape[0]
    toks, row = torch.from_numpy(tokens)[None], torch.from_numpy(page_row)
    pos = start + torch.arange(tb)
    valid = pos < end
    mask = valid.to(torch.float32)[None]
    page_idx = (pos // e.cfg.page_size).clamp(0, row.shape[0] - 1)
    phys = torch.where(valid, row[page_idx], torch.zeros_like(page_idx))
    x = None
    for kind, layer, key in e._plan:
        p = e._params[key]
        if kind == "embed":
            x = qtake(p["W"], toks) * mask[..., None]
        elif kind == "posembed":
            x = x + p["P"][pos.clamp(0, layer.max_length - 1)][None]
        elif kind == "pertoken":
            x, _ = layer.apply(p, {}, x, train=False, mask=mask)
        elif kind == "block":
            x = _host_block_chunk(e, layer, p, e._block_index[key], x, row,
                                  pos, phys, start, mask)
        else:
            x = qdot(x, p["W"]) + p["b"] if "b" in p else qdot(x, p["W"])
    last = x[0, min(max(end - 1 - start, 0), tb - 1)]
    return torch.argmax(last), last


def _host_step(e, tokens, active, lens=None):
    """The decode step's body over host operands (the body is shared)."""
    lens = e.cache.seq_lens if lens is None else lens
    return e._step_body(torch.from_numpy(e.cache.page_table.astype(np.int64)),
                        torch.from_numpy(lens.astype(np.int64)),
                        torch.from_numpy(tokens.astype(np.int64)),
                        torch.from_numpy(active))


def _pools_equal(a, b):
    return torch.equal(a._kpool, b._kpool) and torch.equal(a._vpool, b._vpool)


# ------------------------------------------------------ (a) parity
def test_prefill_and_chunk_programs_are_bitwise_the_host_int_forms(twins):
    """prefill_{tb} and chunk_{tb} over the operand buffers: the token,
    the logits and every pool row bitwise the host-int forms', a chunk
    starting mid-page after a cached prefix."""
    a, b = twins
    rs = np.random.RandomState(1)
    prompt = rs.randint(0, 32, 21)
    slot = a.cache.admit(len(prompt))
    assert b.cache.admit(len(prompt)) == slot
    row = a.cache.page_table[slot].astype(np.int64)
    head = np.zeros((8,), np.int64)
    head[:5] = prompt[:5]
    tok, last = a._prompt("prefill_8", head, 0, 5, row, 0.0, 0, 1)
    want_tok, want = _host_prefill(b, head, 5, row)
    assert int(tok) == int(want_tok) and torch.equal(last, want)
    assert _pools_equal(a, b)
    # positions [5, 21) as one chunk (bucket 32), then [13, 21) again as
    # a bucket-8 chunk over the cached rows
    for start, end, tb in ((5, 21, 32), (13, 21, 8)):
        toks = np.zeros((tb,), np.int64)
        toks[:end - start] = prompt[start:end]
        tok, last = a._prompt(f"chunk_{tb}", toks, start, end, row, 0.0, 0,
                              2)
        want_tok, want = _host_chunk(b, toks, start, end, row)
        assert int(tok) == int(want_tok) and torch.equal(last, want)
        assert _pools_equal(a, b)


def test_decode_verify_and_propose_programs_bitwise(twins):
    """decode, verify_{k+1} and draft_{k} over the operand buffers: greedy
    tokens and logits bitwise the step body over host operands, k+1 of
    them in sequence for the verify and the propose; pools equal."""
    a, b = twins
    rs = np.random.RandomState(2)
    for n in (5, 11):
        s = a.cache.admit(n)
        assert b.cache.admit(n) == s
        p = rs.randint(0, 32, n)
        assert a.prefill(s, p, 0.0, 0)[0] == b.prefill(s, p, 0.0, 0)[0]
    act = np.ones((2,), bool)
    toks, logits = a._decode(a._last_tokens, act, a._temps, a._topks, 3,
                             False)
    want = _host_step(b, b._last_tokens, act)
    assert torch.equal(logits, want)
    assert torch.equal(toks, torch.argmax(want, dim=-1))
    assert _pools_equal(a, b)
    # the verify: k+1 positions from drafted tokens, against k+1 steps
    drafted = rs.randint(0, 32, (2, K)).astype(np.int64)
    vlog = a._verify(a._last_tokens, act, torch.from_numpy(drafted),
                     np.arange(2, dtype=np.int64))
    tok = b._last_tokens.astype(np.int64)
    for i in range(K + 1):
        want = _host_step(b, tok, act, lens=b.cache.seq_lens + i)
        assert torch.equal(vlog[:, i], want), i
        if i < K:
            tok = drafted[:, i]
    assert _pools_equal(a, b)
    # the greedy propose: k argmax steps and one more body
    prop, qlog = a._propose(K, a._last_tokens, act, a._temps, a._topks, 4,
                            False)
    assert prop is a._ops.proposal(K)
    tok = b._last_tokens.astype(np.int64)
    for i in range(K):
        want = _host_step(b, tok, act, lens=b.cache.seq_lens + i)
        assert torch.equal(qlog[:, i], want), i
        tok = torch.argmax(want, dim=-1).numpy()
        assert np.array_equal(prop[:, i].numpy(), tok)
    _host_step(b, tok, act, lens=b.cache.seq_lens + K)
    assert _pools_equal(a, b)


def test_sampled_programs_repeat_for_one_seed_and_counter(nets):
    """A sampling decode step and a sampling propose draw the same tokens
    on two engines of one seed for one counter, and other tokens (on some
    slot) for another counter."""
    engines = [_engine(nets[1], f"s{i}") for i in range(3)]
    try:
        rs = np.random.RandomState(5)
        p = rs.randint(0, 32, 6)
        for e in engines:
            for _ in range(2):
                e.prefill(e.cache.admit(6), p, 0.0, 0)
        act = np.ones((2,), bool)
        temps = np.full((2,), 2.0, np.float32)
        topks = np.zeros((2,), np.int32)
        draws = []
        for e, counter in zip(engines, (7, 7, 8)):
            toks, _ = e._decode(e._last_tokens, act, temps, topks, counter,
                                True)
            prop, _ = e._propose(8, e._last_tokens, act, temps, topks,
                                 counter, True)
            draws.append(np.concatenate([toks.numpy(),
                                         prop.numpy().ravel()]))
        assert np.array_equal(draws[0], draws[1])
        assert not np.array_equal(draws[0], draws[2])
    finally:
        for e in engines:
            e.close()


def test_greedy_program_tokens_match_the_jax_engine(nets):
    """Prefill, a chunk over a cached prefix and eight decode steps: the
    port's programs give the JAX engine's greedy tokens."""
    jnet, pnet = nets
    j = JaxDecodeEngine(jnet, JaxDecodeConfig(slots=2, page_size=8,
                                              prefill_buckets=BUCKETS))
    p = _engine(pnet, "jx")
    try:
        prompt = np.random.RandomState(9).randint(0, 32, 13).astype(np.int32)
        got, want = [], []
        for e, out in ((j, want), (p, got)):
            s = e.cache.admit(len(prompt))
            out.append(int(e.prefill(s, prompt[:8], 0.0, 0)[0]))
            out.append(int(e.prefill_chunk(s, prompt, 8, 5, 0.0, 0)))
            out.extend(int(e.step()[0][s]) for _ in range(8))
        assert got == want
    finally:
        p.close()


def test_warm_runs_each_program_once_and_describes_no_graphs_on_the_cpu(
        nets):
    """warm() meters every program once (the draft's leaving out the
    decode step it never runs); on the CPU nothing is captured and the
    describe() block says so."""
    e = _engine(nets[1], "w", spec_draft="int8", spec_k=K)
    try:
        e.warm()
        assert e.request_path_first_runs == 0
        assert e.warmup_runs == 2 * len(BUCKETS) + 5 + 1
        assert e.draft.warmup_runs == 2 * len(BUCKETS) + 3 + 2
        g = e.describe()["graphs"]
        assert g["programs"] == [] and g["pool_bytes"] == 0
        assert g["captures"] == 0 and g["replays"] == 0
        assert e.describe()["spec"]["draft_graphs"]["programs"] == []
    finally:
        e.close()


def test_operand_buffers_hold_each_operand_in_its_own_view(nets):
    """The staging mirror is the CPU buffer: each put lands in its view
    (floats bit-exact through the int64 buffer), other views untouched."""
    e = _engine(nets[1], "ops")
    try:
        o = e._ops
        o.put("tokens", np.array([3, 4]))
        o.put("temps", np.array([0.7, 1.5], np.float32))
        o.put("counter", 2 ** 40 + 3)
        o.put("ptoks", np.arange(5))
        o.put("end", 5)
        o.load("step")
        assert o.tokens.tolist() == [3, 4]
        assert o.temps.float().tolist() == [np.float32(0.7), 1.5]
        assert int(o.counter) == 2 ** 40 + 3 and o.counter.dim() == 0
        assert o.ptoks[:6].tolist() == [0, 1, 2, 3, 4, 0]
        assert int(o.end) == 5 and int(o.start) == 0
        assert o.table.shape == (2, e.cache.pages_per_slot)
        assert o.proposal(4) is o.proposal(4)
    finally:
        e.close()


# ------------------------------------------- (b) capture-readiness
def _to_meta(tree):
    if isinstance(tree, dict):
        return {k: _to_meta(v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return QTensor(tree.q.to("meta"), tree.scale.to("meta"))
    return tree.to("meta") if isinstance(tree, torch.Tensor) else tree


def _meta_engine(e):
    m = copy.copy(e)
    m._params = _to_meta(e._params)
    m._kpool, m._vpool = e._kpool.to("meta"), e._vpool.to("meta")
    m.device = torch.device("meta")
    return m


def _meta(shape, dtype=torch.int64):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("quantize", [None, "int8", "bf16"])
def test_every_program_body_runs_on_meta_operands(nets, quantize):
    """Every program body runs with meta parameters, pools and operands:
    no value is read on the host inside any of them."""
    e = _engine(nets[1], f"meta-{quantize}", quantize=quantize)
    try:
        m = _meta_engine(e)
        s, p, v = 2, e.cache.pages_per_slot, e.vocab
        table, lens, toks, act = (_meta((s, p)), _meta((s,)), _meta((s,)),
                                  _meta((s,), torch.bool))
        temps, topks, counter = (_meta((s,), torch.float32), _meta((s,)),
                                 _meta(()))
        for t in (None, temps):
            tok, lg = m._decode_fn(table, lens, toks, act, t, topks, counter)
            assert tok.shape == (s,) and lg.shape == (s, v)
            drafted = _meta((s, K))
            out, qlog = m._spec_propose_fn(table, lens, toks, act, t, topks,
                                           counter, drafted)
            assert out is drafted and qlog.shape == (s, K, v)
        assert m._verify_fn(table, lens, toks, _meta((s, K)), act).shape \
            == (s, K + 1, v)
        for tb in BUCKETS:
            one = (_meta((1,), torch.float32), _meta((1,)), counter)
            tok, last = m._prefill_fn(_meta((tb,)), _meta(()), _meta((p,)),
                                      *one)
            assert tok.shape == () and last.shape == (v,)
            tok, last = m._chunk_fn(_meta((tb,)), _meta(()), _meta(()),
                                    _meta((p,)), *one)
            assert tok.shape == () and last.shape == (v,)
    finally:
        e.close()


@pytest.mark.parametrize("read", ["item", "bool", "nonzero", "int"])
def test_meta_operands_refuse_every_host_read(read):
    """The check above has teeth: each kind of host read raises on a meta
    tensor."""
    t = _meta((3,))
    with pytest.raises((RuntimeError, NotImplementedError)):
        {"item": lambda: t[0].item(), "bool": lambda: bool(t[0] > 0),
         "nonzero": lambda: torch.nonzero(t),
         "int": lambda: int(t[0])}[read]()


# ---------------------------------------------------------- (c) noise
def test_noise_is_a_pure_function_of_seed_counter_and_element():
    a = gumbel_noise(0, 5, (4, 32), "cpu")
    assert torch.equal(a, gumbel_noise(0, 5, (4, 32), "cpu"))
    assert torch.equal(a, gumbel_noise(0, torch.tensor(5), (4, 32), "cpu"))
    assert torch.equal(a.reshape(-1)[:64], gumbel_noise(0, 5, (64,), "cpu"))
    assert not torch.equal(a, gumbel_noise(0, 6, (4, 32), "cpu"))
    assert not torch.equal(a, gumbel_noise(1, 5, (4, 32), "cpu"))
    assert torch.isfinite(a).all()


def test_noise_is_gumbel_and_uncorrelated():
    """200,000 draws over 50 counters: the KS distance to the Gumbel CDF
    below the 1 % critical value, neighbours and counters uncorrelated."""
    g = torch.stack([gumbel_noise(3, c, (4000,), "cpu")
                     for c in range(50)]).double()
    x = np.sort(g.numpy().ravel())
    n = x.size
    cdf = np.exp(-np.exp(-x))
    ks = max(np.max(np.arange(1, n + 1) / n - cdf),
             np.max(cdf - np.arange(n) / n))
    assert ks < 1.63 / np.sqrt(n), ks
    bound = 4.0 / np.sqrt(g.shape[1])
    for a, b in ((g[:, :-1], g[:, 1:]), (g[:-1], g[1:])):
        r = np.corrcoef(a.numpy().ravel(), b.numpy().ravel())[0, 1]
        assert abs(r) < bound, r
