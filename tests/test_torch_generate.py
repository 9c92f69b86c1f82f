"""The port's generation path on the CPU: `ServedLM` (engine + the
continuous-batching scheduler), `ModelRegistry.deploy_lm`, the HTTP
`POST /v1/models/{name}/generate` and `serving.cli.build` with `--lm`.

These are the JAX package's scheduler and HTTP assertions
(tests/test_decode.py) held against the port; greedy tokens are further
held to the JAX engine's on the same weights. The reference's eos test
assumes its greedy run's third token first occurs at index 2; here the
eos is a token whose first occurrence the test has found.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from deeplearning4j_tpu.serving.decode import (
    DecodeConfig as JaxDecodeConfig, DecodeEngine as JaxDecodeEngine,
)
from deeplearning4j_tpu.serving.registry import (
    load_servable as jax_load_servable,
)
from deeplearning4j_tpu_torch.serving import cli
from deeplearning4j_tpu_torch.serving.batcher import (
    DeadlineExceededError, ServerDrainingError, ServerOverloadedError,
)
from deeplearning4j_tpu_torch.serving.decode import (
    DecodeConfig, DecodeEngine, DecodeScheduler, GenerateRequest, ServedLM,
)
from deeplearning4j_tpu_torch.serving.registry import (
    ModelLoadError, ModelRegistry, load_servable,
)
from deeplearning4j_tpu_torch.serving.server import ModelServer

ZOO_SRC = ("zoo:TransformerLM?vocab_size=48&n_layers=1&n_embd=32"
           "&n_heads=4&seq_length=32")


def _net():
    return load_servable(ZOO_SRC, device="cpu")


def drain_events(req, timeout=30.0):
    """Collect ((kind, payload, t_monotonic)) until done/error."""
    out = []
    deadline = time.monotonic() + timeout
    while True:
        ev = req.events.get(timeout=max(0.1, deadline - time.monotonic()))
        out.append((ev[0], ev[1], time.monotonic()))
        if ev[0] in ("done", "error"):
            return out


def _tokens(evs):
    return [p for k, p, _ in evs if k == "token"]


# --------------------------------------------------- continuous batching
@pytest.fixture(scope="module")
def served_lm():
    lm = ServedLM("cb-lm", _net(), ZOO_SRC,
                  decode=DecodeConfig(slots=2, page_size=8, queue_limit=8))
    yield lm
    lm.shutdown(drain=False, timeout=5)


def test_late_join_streams_before_batch_drains(served_lm):
    """Request B, submitted while A is mid-generation, gets its first
    token before A finishes — token-level join, not request-level
    batching."""
    joins_before = served_lm.scheduler.stats["preempted_joins"]
    a = served_lm.generate([1, 2, 3], max_new_tokens=24,
                           temperature=0.7, top_k=8)
    first_a = a.events.get(timeout=30)
    assert first_a[0] == "token"
    b = served_lm.generate([4, 5], max_new_tokens=4)
    b_events = drain_events(b)
    a_events = drain_events(a)
    assert b_events[-1][0] == "done" and a_events[-1][0] == "done"
    assert b_events[0][2] < a_events[-1][2], \
        "late join waited for the running batch to drain"
    assert served_lm.scheduler.stats["preempted_joins"] > joins_before


def test_eos_and_temperature_sampling(served_lm):
    prompt = [7, 8, 9]
    toks = _tokens(drain_events(served_lm.generate(prompt,
                                                   max_new_tokens=12)))
    assert len(toks) == 12
    # greedy is deterministic: a token whose first occurrence is at i>=1
    firsts = [i for i in range(1, len(toks)) if toks[i] not in toks[:i]]
    assert firsts, toks
    i = firsts[0]
    evs = drain_events(served_lm.generate(prompt, max_new_tokens=12,
                                          eos_id=toks[i]))
    assert evs[-1][1]["finish_reason"] == "eos"
    assert _tokens(evs) == toks[:i]
    # a sampled run stays in vocab and honors the token budget
    toks = _tokens(drain_events(served_lm.generate(
        prompt, max_new_tokens=5, temperature=1.3, top_k=5)))
    assert len(toks) == 5 and all(0 <= t < 48 for t in toks)


def test_greedy_tokens_match_the_jax_engine(served_lm):
    """The served stream's greedy tokens are the JAX engine's on the same
    weights (the zoo network's params go across as numpy)."""
    jnet = jax_load_servable(ZOO_SRC)
    jnet.params = _np_tree(served_lm.model.params)
    j = JaxDecodeEngine(jnet, JaxDecodeConfig(slots=1, page_size=8,
                                              prefill_buckets=(8, 32)))
    prompt = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5], np.int32)
    slot = j.cache.admit(len(prompt))
    tok, _ = j.prefill(slot, prompt, 0.0, 0)
    want = [tok] + [int(j.step()[0][slot]) for _ in range(9)]
    got = _tokens(drain_events(served_lm.generate(prompt,
                                                  max_new_tokens=10)))
    assert got == want


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return t.numpy()


def test_generation_caps_at_max_context(served_lm):
    """max_tokens beyond the KV capacity is clamped server-side; the
    stream ends cleanly at the context cap."""
    evs = drain_events(served_lm.generate(list(range(28)),
                                          max_new_tokens=500))
    assert evs[-1][0] == "done"
    assert len(_tokens(evs)) == 32 - 28


def test_join_queue_overload_raises_429_shape(served_lm):
    live = [served_lm.generate([1], max_new_tokens=40, temperature=0.5)
            for _ in range(2)]
    with pytest.raises(ServerOverloadedError):
        for _ in range(16):                   # queue_limit is 8
            live.append(served_lm.generate([1], max_new_tokens=40))
    for r in live:
        r.cancel()
        drain_events(r, timeout=60)


def test_invalid_prompts_rejected(served_lm):
    with pytest.raises(ValueError):
        served_lm.generate([], max_new_tokens=2)
    with pytest.raises(ValueError):
        served_lm.generate([999], max_new_tokens=2)
    with pytest.raises(ValueError):
        served_lm.generate([-1], max_new_tokens=2)
    with pytest.raises(ValueError):
        served_lm.generate(list(range(32)), max_new_tokens=2)  # no room
    with pytest.raises(ValueError):
        served_lm.generate([1], max_new_tokens=0)
    # a swap to another vocabulary and a rollback with no history are
    # rejected; the servable keeps serving version 1
    with pytest.raises(ModelLoadError, match="swap rejected"):
        served_lm.swap(ZOO_SRC.replace("vocab_size=48", "vocab_size=40"))
    with pytest.raises(ModelLoadError, match="no previous version"):
        served_lm.rollback()
    assert served_lm.describe()["active_version"] == 1
    assert len(served_lm.versions) == 1


def test_oversubscribed_pool_stall_releases_on_cancel():
    """All slots page-stalled on a dry pool must still honor
    cancellation — releasing a stalled slot is what refills the pool."""
    lm = ServedLM("stall-lm", _net(), ZOO_SRC,
                  decode=DecodeConfig(slots=2, page_size=8, pool_pages=5))
    try:
        cache = lm.scheduler.admitting_engine().cache
        reqs = [lm.generate([1] * 8, max_new_tokens=500, temperature=0.5)
                for _ in range(2)]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (
                cache.free_pages() > 0 or cache.stats["page_stalls"] == 0):
            time.sleep(0.02)
        assert cache.free_pages() == 0 and cache.stats["page_stalls"] > 0
        for r in reqs:
            r.cancel()
        evs = [drain_events(r, timeout=30) for r in reqs]
        assert all(e[-1][0] == "done" for e in evs)
        assert cache.free_pages() == 4
        assert drain_events(lm.generate([1, 2], max_new_tokens=2))[-1][0] \
            == "done"
    finally:
        lm.shutdown(drain=False, timeout=5)


# -------------------------------------- prefix cache + chunked prefill
def _greedy(lm, prompt, n=8):
    evs = drain_events(lm.generate(prompt, max_new_tokens=n))
    assert evs[-1][0] == "done", evs[-1]
    return _tokens(evs), evs[-1][1]


@pytest.fixture(scope="module")
def parity_lms():
    """One model behind three decode configs: prefix cache on (default),
    off, and off with a tiny chunk budget."""
    net = _net()
    lms = {
        "on": ServedLM("par-on", net, ZOO_SRC,
                       decode=DecodeConfig(slots=2, page_size=8)),
        "off": ServedLM("par-off", net, ZOO_SRC,
                        decode=DecodeConfig(slots=2, page_size=8,
                                            prefix_cache=False)),
        "chunk": ServedLM("par-chunk", net, ZOO_SRC,
                          decode=DecodeConfig(slots=2, page_size=8,
                                              prefix_cache=False,
                                              prefill_chunk_tokens=8)),
    }
    yield lms
    for lm in lms.values():
        lm.shutdown(drain=False, timeout=5)


def test_prefix_cache_greedy_parity_cold_hot_and_cow(parity_lms):
    on, off = parity_lms["on"], parity_lms["off"]
    prefix = list(range(16))                      # 2 full pages
    t_on, i_on = _greedy(on, prefix + [17, 18, 19])
    t_off, i_off = _greedy(off, prefix + [17, 18, 19])
    assert t_on == t_off
    assert i_on["cached_tokens"] == 0 and i_off["cached_tokens"] == 0
    t_on, i_on = _greedy(on, prefix + [20, 21])
    t_off, _ = _greedy(off, prefix + [20, 21])
    assert t_on == t_off and i_on["cached_tokens"] == 16
    t_on, i_on = _greedy(on, prefix)
    t_off, _ = _greedy(off, prefix)
    assert t_on == t_off and i_on["cached_tokens"] == 15


def test_chunked_prefill_parity_and_chunk_accounting(parity_lms):
    off, chunk = parity_lms["off"], parity_lms["chunk"]
    prompt = list(np.random.RandomState(5).randint(0, 48, 20))
    t_c, i_c = _greedy(chunk, prompt)
    t_o, i_o = _greedy(off, prompt)
    assert t_c == t_o, (t_c, t_o)
    assert i_c["prefill_chunks"] == 3             # 8 + 8 + 4
    assert i_o["prefill_chunks"] == 1


def test_chunked_and_cow_traffic_never_first_runs_on_request_path(
        parity_lms):
    """After hot, COW and chunked traffic, no program ran first for a
    live request: warm() covered the chunk ladder, the COW copy, the
    KV-fabric page extract and land, and both decode step variants."""
    for lm in parity_lms.values():
        eng = lm.scheduler.admitting_engine()
        assert eng.request_path_first_runs == 0
        assert eng.warmup_runs == 2 * len(eng.prefill_buckets) + 5
        assert eng.steps > 0


def _sched(name, **cfg):
    eng = DecodeEngine(_net(), DecodeConfig(page_size=8, **cfg), name=name)
    eng.warm()
    sched = DecodeScheduler(name, queue_limit=16)
    sched._started = True                 # keep the loop thread off
    sched.install(eng, version=1)
    return eng, sched


def test_burst_admissions_drain_queue_in_one_tick():
    eng, sched = _sched("burst", slots=4)
    reqs = [GenerateRequest([1, 2, 3], max_new_tokens=1) for _ in range(6)]
    for r in reqs:
        sched.submit(r)
    run = sched._runs[-1]
    assert sched._admit() is True
    assert len(run.prefill) == 4
    assert sched.queue_state()[0] == 2
    assert sched._prefill_tick() is True
    assert len(run.prefill) == 0 and len(run.slot_req) == 0
    assert sched._admit() is True
    assert len(run.prefill) == 2 and sched.queue_state()[0] == 0
    sched._prefill_tick()
    for r in reqs:
        assert r.done.is_set() and r.finish_reason == "length"
    sched._stop.set()
    eng.close()


def test_prefill_budget_caps_tokens_per_tick():
    eng, sched = _sched("budget", slots=2, prefill_chunk_tokens=8)
    req = GenerateRequest(list(range(24)), max_new_tokens=2)
    sched.submit(req)
    assert sched._admit() is True
    run = sched._runs[-1]
    job = next(iter(run.prefill.values()))
    for expect_pos in (8, 16, 24):
        sched._prefill_tick()
        assert job.pos == expect_pos
    assert not run.prefill and len(run.slot_req) == 1
    assert req.n_emitted == 1
    sched._step_all()
    assert req.done.is_set()
    sched._stop.set()
    eng.close()


# ------------------------------------------------------------- registry
def test_deploy_lm_variants_and_kind_collisions():
    registry = ModelRegistry(device="cpu")
    try:
        lm = registry.deploy_lm("m", ZOO_SRC + "@int8",
                                decode=DecodeConfig(slots=1, page_size=8))
        assert lm.cfg.quantize == "int8" and lm.cfg.slots == 1
        assert lm.describe()["decode"]["quantize"] == "int8"
        with pytest.raises(ModelLoadError, match="already deployed"):
            registry.deploy("m", ZOO_SRC, buckets=(1,))
        # redeploying the name is a rolling swap that keeps the config
        assert registry.deploy_lm("m", ZOO_SRC) is lm
        assert lm.describe()["active_version"] == 2
        assert lm.scheduler.admitting_engine().cfg.quantize == "int8"
        spec = registry.deploy_lm("s", ZOO_SRC + "@spec",
                                  decode=DecodeConfig(slots=1, page_size=8))
        assert spec.cfg.spec_draft == "int8"
        assert spec.describe()["decode"]["spec"]["k"] == 4
        registry.undeploy("m", drain=False)
        registry.deploy("m", ZOO_SRC, buckets=(1,))
        with pytest.raises(ModelLoadError, match="PREDICT"):
            registry.deploy_lm("m", ZOO_SRC)
    finally:
        registry.shutdown(drain=False)


# ----------------------------------------------------------------- HTTP
@pytest.fixture(scope="module")
def lm_server():
    registry = ModelRegistry(device="cpu")
    registry.deploy_lm("lm", ZOO_SRC,
                       decode=DecodeConfig(slots=2, page_size=8))
    server = ModelServer(registry, port=0, default_deadline_s=60.0)
    yield server, registry
    server.drain(timeout=10)


def _gen(url, payload, name="lm", timeout=60):
    return urllib.request.urlopen(urllib.request.Request(
        url + f"/v1/models/{name}/generate",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}), timeout=timeout)


def _http_error(fn):
    with pytest.raises(urllib.error.HTTPError) as e:
        fn()
    return e.value.code, e.value.headers, json.loads(e.value.read())


def test_http_sse_stream_and_json(lm_server):
    server, _ = lm_server
    r = _gen(server.url, {"prompt": [1, 2, 3], "max_tokens": 5})
    assert r.status == 200
    assert r.headers.get("Content-Type") == "text/event-stream"
    assert r.headers.get("X-Model-Version") == "1"
    events = [json.loads(line[6:]) for line in r
              if line.startswith(b"data: ")]
    toks = [e["token"] for e in events if "token" in e]
    assert len(toks) == 5
    assert [e["index"] for e in events if "token" in e] == list(range(5))
    done = events[-1]
    assert done["done"] and done["finish_reason"] == "length"
    assert done["cached_tokens"] == 0 and done["prefill_chunks"] == 1
    assert done["ttft_ms"] > 0 and done["spec_proposed"] == 0
    r = _gen(server.url, {"prompt": [1, 2, 3], "max_tokens": 5,
                          "stream": False})
    doc = json.loads(r.read())
    assert doc["tokens"] == toks
    assert doc["finish_reason"] == "length"
    assert doc["ttft_ms"] is not None and doc["version"] == 1
    assert {"cached_tokens", "prefill_chunks", "spec_rounds",
            "latency_ms"} <= set(doc)


def test_http_generate_error_mapping(lm_server, monkeypatch):
    server, registry = lm_server
    url = server.url
    code, _, doc = _http_error(lambda: _gen(url, {"prompt": [9999]}))
    assert code == 400 and "prompt ids" in doc["error"]
    code, _, _ = _http_error(lambda: _gen(url, {"prompt": [1],
                                                "eos_id": "x"}))
    assert code == 400
    code, _, _ = _http_error(lambda: _gen(url, {"tokens": [1]}))
    assert code == 400
    code, _, _ = _http_error(lambda: _gen(url, {}, name="nope"))
    assert code == 404
    # generate against a predict servable -> 400 with a pointed message
    registry.deploy("tiny", ZOO_SRC, buckets=(1,))
    code, _, doc = _http_error(lambda: _gen(url, {"prompt": [1]},
                                            name="tiny"))
    assert code == 400 and "predict servable" in doc["error"]
    registry.undeploy("tiny")
    # predict against an LM -> 400
    code, _, doc = _http_error(lambda: urllib.request.urlopen(
        urllib.request.Request(url + "/v1/models/lm/predict",
                               data=b'{"inputs": [[1]]}',
                               headers={"Content-Type": "application/json"}),
        timeout=10))
    assert code == 400 and "generate" in doc["error"]
    served = registry.get("lm")
    for exc, want in ((ServerOverloadedError("full"), 429),
                      (ServerDrainingError("draining"), 503),
                      (DeadlineExceededError("late"), 504)):
        def boom(*a, exc=exc, **k):
            raise exc
        monkeypatch.setattr(served, "generate", boom)
        code, headers, _ = _http_error(lambda: _gen(url, {"prompt": [1]}))
        assert code == want
        if want in (429, 503):
            assert 1 <= int(headers["Retry-After"]) <= 5
    monkeypatch.undo()
    models = json.loads(urllib.request.urlopen(url + "/v1/models/lm",
                                               timeout=10).read())
    assert models["kind"] == "lm" and models["vocab_size"] == 48


def test_http_concurrent_streams_zero_errors(lm_server):
    server, _ = lm_server
    errors, tokens = [], []

    def worker(i):
        try:
            r = _gen(server.url, {"prompt": [i % 48, 1], "max_tokens": 6,
                                  "temperature": 0.9, "top_k": 4})
            evs = [json.loads(line[6:]) for line in r
                   if line.startswith(b"data: ")]
            if not evs or not evs[-1].get("done"):
                errors.append((i, "truncated"))
            tokens.append(sum(1 for e in evs if "token" in e))
        except Exception as e:              # noqa: BLE001
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert all(n == 6 for n in tokens), tokens


# ------------------------------------------------------------------ CLI
def test_cli_build_serves_lm_beside_a_predict_model(capsys):
    args = cli.build_parser().parse_args([
        "--model", f"p={ZOO_SRC}", "--lm", f"g={ZOO_SRC}",
        "--lm", f"g8={ZOO_SRC}@int8", "--decode-slots", "2",
        "--decode-page-size", "8", "--prefill-buckets", "8,32",
        "--prefill-chunk-tokens", "8", "--no-prefix-cache",
        "--port", "0", "--buckets", "1", "--device", "cpu"])
    registry, server = cli.build(args)
    try:
        first = json.loads(capsys.readouterr().out.splitlines()[0])
        assert first["models"] == ["g", "g8", "p"]
        assert "/v1/models/{name}/generate" in first["endpoints"]
        g = registry.get("g")
        assert g.cfg == DecodeConfig(slots=2, page_size=8,
                                     prefill_buckets=(8, 32),
                                     prefix_cache=False,
                                     prefill_chunk_tokens=8)
        assert registry.get("g8").cfg.quantize == "int8"
        doc = json.loads(_gen(server.url, {"prompt": list(range(20)),
                                           "max_tokens": 3,
                                           "stream": False}, "g").read())
        assert len(doc["tokens"]) == 3 and doc["prefill_chunks"] == 3
    finally:
        server.drain(timeout=10)


@pytest.mark.parametrize("flags,match", [
    (["--kv-roles", "prefill,decode"], "A.14"),
    (["--disagg-min-tokens", "64"], "A.14"),
    (["--disagg-timeout-s", "5"], "A.14"),
    (["--kv-spill-pages", "-1"], ">= 0"),
    (["--lm", "bad"], "NAME=SOURCE"),
])
def test_cli_refuses_unported_decode_flags(flags, match):
    """The fleet mode's KV flags (ROADMAP A.14) and malformed values
    exit; the single-server decode flags build (next test)."""
    args = cli.build_parser().parse_args(
        ["--lm", f"g={ZOO_SRC}", "--device", "cpu", "--port", "0"] + flags)
    with pytest.raises(SystemExit, match=match):
        cli.build(args)


@pytest.mark.parametrize("flags,check", [
    (["--spec-draft", "int8"],
     lambda g, s: g.cfg.spec_draft == "int8"
     and g.scheduler.admitting_engine().spec_enabled),
    (["--spec-draft", "bf16", "--spec-k", "2"],
     lambda g, s: g.scheduler.admitting_engine().describe()["spec"]["k"]
     == 2),
    (["--kv-spill-pages", "64"],
     lambda g, s: g.scheduler.admitting_engine().spill.pages == 64),
    (["--kv-role", "prefill"], lambda g, s: s.kv_role == "prefill"),
])
def test_cli_builds_spec_spill_and_kv_role(flags, check):
    """--spec-*, --kv-spill-pages and --kv-role build a DecodeConfig and
    a server instead of exiting, and the servable generates."""
    args = cli.build_parser().parse_args(
        ["--lm", f"g={ZOO_SRC}", "--device", "cpu", "--port", "0",
         "--decode-slots", "2", "--decode-page-size", "8",
         "--prefill-buckets", "8,32"] + flags)
    registry, server = cli.build(args)
    try:
        g = registry.get("g")
        assert check(g, server)
        doc = json.loads(_gen(server.url, {"prompt": [1, 2, 3],
                                           "max_tokens": 4,
                                           "stream": False}, "g").read())
        assert len(doc["tokens"]) == 4
    finally:
        server.drain(timeout=10)
