#!/usr/bin/env python
"""Decode smoke: the acceptance gate for token-level continuous batching.

    python -m deeplearning4j_tpu_torch.tools.decode_smoke \
        [--device cpu] [--out DECODE.json]

The port's counterpart of the JAX package's `tools/decode_smoke.py`,
with the same phases, assertions and report keys; every servable runs on
``--device`` (CUDA by default; it raises without CUDA unless ``cpu`` is
asked). In one process (no network egress):

1. deploys a `zoo:TransformerLM?...`-sized decode servable (plus int8 and
   bf16 post-training-quantized variants) behind a ModelServer — the zoo
   kwargs source means no checkpoint is needed to size the model;
2. drives N concurrent closed-loop token STREAMS through the generate
   surface (`tools/loadgen.py`'s decode mode as a library) and, MID
   TRAFFIC, hot-swaps the servable to a differently-seeded model —
   asserts ZERO 5xx across every stream and that post-swap streams
   answer from the new version while pre-swap streams finish cleanly on
   the old one (the rolling-swap contract);
3. scrapes /metrics and asserts the decode compile ledger balances:
   ``serving_decode_compiles_total`` summed == ``serving_decode_warmup_
   runs_total`` summed — every prefill bucket and the decode step
   ran first during warmup, never on the request path — and that
   ``serving_decode_preempted_joins_total`` > 0 (streams actually joined
   a running batch: continuous batching happened, it wasn't sequential);
4. measures the quantized variants against the base engine on a shared
   token set (`quantize.quality_delta`): next-token perplexity delta and
   mean absolute logit error per variant;
5. drives a deterministic SHARED-PREFIX workload (loadgen's
   ``prefix_mix``) against a longer-context servable and
   asserts the KV prefix cache engaged (cache_hit_rate > 0), then
   measures cold-vs-hot TTFT on a controlled sequential pass — the
   acceptance bar is hot p99 at least 2x better than cold;
6. measures short-stream inter-token p99 while a LONG-PROMPT INTERFERER
   continuously admits, with chunked prefill on vs off — chunking must
   improve the interferer ITL p99 (head-of-line-free prefill);
7. drives a speculative-decoding A/B (same greedy prompts against an
   ``@spec:draft=int8,k=12`` self-drafting servable and its plain twin):
   token streams must be EXACTLY equal, the acceptance rate must clear
   0.5, per-stream mean ITL p99 must improve, and the compile ledger
   must still balance with the draft/verify programs live;
8. exercises the tiered KV fabric's host-RAM spill tier on a servable
   with a deliberately tight HBM pool: distinct long prompts force
   zero-ref retained prefixes to demote to the pinned host store, then
   re-driving the first prompt must promote its pages back (spill hit)
   and reproduce the EXACT greedy tokens of the cold pass — the banked
   ``decode_spill_hit_rate`` is the admission hit fraction;
9. stands up a real 2-replica in-process fleet and runs the
   prefix-affinity A/B: two routers over the SAME fleet (affinity on vs
   off), disjoint page-aligned shared-prefix sets per arm, ownership
   refreshed via the /readyz heartbeat between the cold and measured
   passes — affinity steering must beat random (p2c) routing on
   repeat-prefix TTFT p99, and one loadgen ``prefix_mix`` pass
   through the affinity router banks the per-replica cache-hit split;
10. banks a bench-style ``sweep`` with the decode throughput/latency row
   (``decode_tokens_sec``, ``decode_ttft_p99_ms``, ``decode_itl_p99_ms``),
   the prefix-cache row (``decode_cache_hit_rate``,
   ``decode_ttft_hot_p99_ms``, ``decode_ttft_cold_p99_ms``), the
   interferer row (``decode_itl_interferer_p99_ms`` + the ungated
   chunking-off reference), the speculative row
   (``decode_spec_acceptance_rate`` + its ITL A/B) and one quality row
   per variant, in the ``--out`` JSON. A ``calib_cpu_ms`` machine-speed
   reference (fixed numpy matmul timing, sampled before and after the
   measured phases) rides along so runs on hosts of different speed can
   be compared.

Exit 0 on success, 1 on failure; prints the JSON summary either way.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import urllib.request


def _metric_sum(metrics_text: str, family: str) -> float:
    total = 0.0
    for line in metrics_text.splitlines():
        if line.startswith(family + "{") or line.startswith(family + " "):
            try:
                total += float(line.rsplit(" ", 1)[1])
            except ValueError:
                pass
    return total


def _p99_ms(samples) -> float:
    from deeplearning4j_tpu_torch.tools.loadgen import percentile
    return round((percentile(sorted(samples), 99) or 0.0) * 1e3, 3)


def _metric_sum_where(metrics_text: str, family: str, needle: str) -> float:
    """Like _metric_sum but only lines whose label set contains `needle`
    (e.g. 'model="lm_spill"') — the fabric phases share one process-wide
    registry with every other servable in this smoke."""
    total = 0.0
    for line in metrics_text.splitlines():
        if line.startswith(family + "{") and needle in line:
            try:
                total += float(line.rsplit(" ", 1)[1])
            except ValueError:
                pass
    return total


def _sse_ttft(url: str, model: str, prompt, max_new_tokens: int = 2,
              timeout: float = 120.0):
    """One greedy generate through a router's SSE surface; returns
    (ttft_s, tokens, X-Served-By header)."""
    body = json.dumps({"prompt": list(prompt),
                       "max_new_tokens": max_new_tokens,
                       "temperature": 0.0}).encode()
    req = urllib.request.Request(
        f"{url}/v1/models/{model}/generate", data=body,
        headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    ttft, toks = None, []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        served = r.headers.get("X-Served-By")
        for raw in r:
            line = raw.decode("utf-8", "replace").strip()
            if not line.startswith("data: "):
                continue
            ev = json.loads(line[6:])
            if "token" in ev:
                if ttft is None:
                    ttft = time.perf_counter() - t0
                toks.append(ev["token"])
    return ttft, toks, served


def _drain(req, timeout=120.0):
    """Consume one library GenerateRequest; returns (token count,
    [inter-token gaps s])."""
    import time as _t
    ntok, last, itls = 0, None, []
    deadline = _t.monotonic() + timeout
    while True:
        ev = req.events.get(timeout=max(0.1, deadline - _t.monotonic()))
        if ev[0] == "token":
            now = _t.perf_counter()
            if last is not None:
                itls.append(now - last)
            last = now
            ntok += 1
        elif ev[0] == "done":
            return ntok, itls
        else:
            raise ev[1]


def _interferer_itl_p99(lm, vocab: int, rs, n_streams: int = 2,
                        gen_tokens: int = 48) -> float:
    """Short-stream inter-token p99 while a long-prompt interferer
    continuously admits (each interferer prompt is unique, so its whole
    suffix really prefills). The chunking A/B isolates head-of-line
    blocking: with chunking off every interferer admission stalls the
    running streams for one monolithic prefill."""
    import threading
    import time as _t

    import numpy as np
    itls, errs = [], []
    done = threading.Event()
    # per-thread RNG streams derived from the caller's seed: the chunked
    # and nochunk phases are seeded identically, and thread interleaving
    # must not reorder draws between them — the A/B compares the same
    # prompt sets
    seeds = rs.randint(0, 2 ** 31 - 1, n_streams + 1)

    def short(i):
        try:
            srs = np.random.RandomState(seeds[i])
            req = lm.generate(srs.randint(0, vocab, 8).tolist(),
                              max_new_tokens=gen_tokens)
            _, gaps = _drain(req)
            itls.extend(gaps)
        except Exception as e:          # noqa: BLE001 — asserted below
            errs.append(repr(e))

    def interferer():
        irs = np.random.RandomState(seeds[-1])
        while not done.is_set():
            try:
                req = lm.generate(irs.randint(0, vocab, 448).tolist(),
                                  max_new_tokens=1)
                _drain(req)
            except Exception as e:      # noqa: BLE001
                errs.append(repr(e))
                return
            _t.sleep(0.001)

    threads = [threading.Thread(target=short, args=(i,), daemon=True,
                                name=f"smoke-short-{i}")
               for i in range(n_streams)]
    intf = threading.Thread(target=interferer, daemon=True,
                            name="smoke-interferer")
    for t in threads:
        t.start()
    intf.start()
    for t in threads:
        t.join(timeout=300)
    done.set()
    intf.join(timeout=300)
    if errs:
        raise RuntimeError(f"interferer phase errors: {errs}")
    return _p99_ms(itls)


SPEC_ARCH = ("zoo:TransformerLM?vocab_size=32&n_layers=1"
             "&n_embd=16&n_heads=1&seq_length=224")


def _stream(lm, prompt, n=120):
    """One greedy stream; returns (tokens, inter-token gaps s, done-event
    info)."""
    req = lm.generate(prompt, max_new_tokens=n)
    toks, gaps, last = [], [], None
    deadline = time.monotonic() + 120.0
    while True:
        ev = req.events.get(timeout=max(0.1, deadline - time.monotonic()))
        if ev[0] == "token":
            now = time.perf_counter()
            if last is not None:
                gaps.append(now - last)
            last = now
            toks.append(ev[1])
        elif ev[0] == "done":
            return toks, gaps, ev[1]
        else:
            raise ev[1]


def spec_ab(registry):
    """The speculative-decoding A/B: parity + acceptance + ITL. Deploys
    ``lm_spec_base`` and its ``@spec:draft=int8,k=12`` twin on
    `registry` and drives 52 greedy streams of 120 tokens through each
    (after two throwaway streams an arm). Returns (the ``spec_ab``
    summary, its failures)."""
    import numpy as np

    from deeplearning4j_tpu_torch.serving.decode import DecodeConfig

    # A dedicated tiny arch: the int8 self-draft runs the same compute
    # per position as its target, so the ITL win comes purely from
    # amortizing the fixed per-token costs (dispatch + scheduler tick: 2
    # dispatches and 1 tick per accepted burst vs 1 of each per token).
    # The per-position body compute is paid TWICE under speculation, so
    # the margin needs a large k over a very cheap body — n_embd 16 / 1
    # head / vocab 32 with k=12.
    spec_cfg = DecodeConfig(slots=2, page_size=16)
    registry.deploy_lm("lm_spec_base", SPEC_ARCH, decode=spec_cfg)
    registry.deploy_lm("lm_spec", SPEC_ARCH + "@spec:draft=int8,k=12",
                       decode=spec_cfg)
    lsb, lsp = registry.get("lm_spec_base"), registry.get("lm_spec")
    # 52 streams: the p99 across per-stream means then sheds the single
    # worst stream — one OS scheduling blip cannot decide the gate
    rs3 = np.random.RandomState(17)
    spec_prompts = [rs3.randint(0, 32, 8).tolist() for _ in range(52)]
    for _ in range(2):          # throwaway streams warm each arm
        for lm in (lsb, lsp):
            _stream(lm, spec_prompts[0], n=16)
    base_itl, spec_itl = [], []
    spec_prop = spec_acc = spec_mismatches = 0
    for prompt in spec_prompts:
        bt, bg, _ = _stream(lsb, prompt)
        st, sg, info = _stream(lsp, prompt)
        if bt != st:
            spec_mismatches += 1
        if bg:
            base_itl.append(sum(bg) / len(bg))
        if sg:
            spec_itl.append(sum(sg) / len(sg))
        spec_prop += int(info.get("spec_proposed") or 0)
        spec_acc += int(info.get("spec_accepted") or 0)
    spec_rate = round(spec_acc / spec_prop, 4) if spec_prop else 0.0
    spec_p99 = _p99_ms(spec_itl)
    spec_base_p99 = _p99_ms(base_itl)
    summary = {
        "streams": len(spec_prompts), "mismatched_streams": spec_mismatches,
        "proposed": spec_prop, "accepted": spec_acc,
        "acceptance_rate": spec_rate,
        "itl_p99_ms": spec_p99, "base_itl_p99_ms": spec_base_p99}
    failures = []
    if spec_mismatches:
        failures.append(
            f"speculative greedy output diverged from the plain twin on "
            f"{spec_mismatches}/{len(spec_prompts)} streams — speculation "
            f"changed the distribution")
    if spec_prop <= 0:
        failures.append("speculation never proposed a token — "
                        "the draft path did not engage")
    elif spec_rate <= 0.5:
        failures.append(
            f"self-draft acceptance rate {spec_rate} not > 0.5 — the "
            f"int8 draft disagrees with its own target too often")
    if spec_p99 >= spec_base_p99:
        failures.append(
            f"speculation did not improve per-stream mean ITL p99 "
            f"({spec_p99}ms spec vs {spec_base_p99}ms plain)")
    return summary, failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--streams", type=int, default=4,
                   help="concurrent closed-loop token streams")
    p.add_argument("--requests", type=int, default=24,
                   help="logical streams per traffic phase (2 phases)")
    p.add_argument("--prompt-len", type=int, default=12)
    p.add_argument("--max-new-tokens", type=int, default=24)
    p.add_argument("--vocab", type=int, default=512)
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--n-embd", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--seq-length", type=int, default=128)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--out", default=None, metavar="PATH",
                   help="write the summary JSON here too")
    p.add_argument("--device", default="cuda",
                   help="torch device of every servable (default cuda; "
                        "raises without it)")
    args = p.parse_args(argv)

    import numpy as np

    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    from deeplearning4j_tpu_torch.serving.decode import DecodeConfig
    from deeplearning4j_tpu_torch.serving.quantize import quality_delta
    from deeplearning4j_tpu_torch.tools.loadgen import (
        LoadGen, calibrate as _calibrate, parse_priority_mix,
    )
    from deeplearning4j_tpu_torch.util.platform import (
        resolve_device, set_f32_matmul_exact,
    )
    device = resolve_device(args.device)
    set_f32_matmul_exact()

    failures = []
    summary = {"device": str(device)}
    # machine-speed reference, sampled before AND after the measured
    # phases: the banked figure reflects the host across the whole window
    calib_start = _calibrate()
    arch = (f"zoo:TransformerLM?vocab_size={args.vocab}"
            f"&n_layers={args.n_layers}&n_embd={args.n_embd}"
            f"&n_heads={args.n_heads}&seq_length={args.seq_length}")
    cfg = DecodeConfig(slots=args.slots, page_size=args.page_size)

    registry = ModelRegistry(device=device)
    t0 = time.perf_counter()
    registry.deploy_lm("lm", arch, decode=cfg)
    registry.deploy_lm("lm_int8", arch + "@int8", decode=cfg)
    registry.deploy_lm("lm_bf16", arch + "@bf16", decode=cfg)
    # the prefix/interferer phases need room for long prompts: a fixed
    # 512-token-context sizing (independent of the CLI sizing knobs) so
    # cold prefill is genuinely heavier than a cache-hit suffix — on CPU
    # with tiny models, per-program dispatch overhead flattens the ratio
    # unless the prompt is long enough for compute to dominate. Same
    # model + config except the chunking knob — the interferer A/B.
    arch_long = (f"zoo:TransformerLM?vocab_size={args.vocab}"
                 f"&n_layers=2&n_embd=64&n_heads=4&seq_length=512")
    registry.deploy_lm("lm_prefix", arch_long,
                       decode=DecodeConfig(slots=args.slots, page_size=16))
    registry.deploy_lm("lm_nochunk", arch_long,
                       decode=DecodeConfig(slots=args.slots, page_size=16,
                                           prefill_chunk_tokens=0))
    summary["warmup_s"] = round(time.perf_counter() - t0, 2)
    server = ModelServer(registry, port=0, default_deadline_s=120.0)

    # ------------------------------------------------- quantized variants
    # measured BEFORE the swap phase: the variants were built from the
    # same weights the base currently serves — after the mid-traffic swap
    # the base answers from a different seed and the delta means nothing
    rs = np.random.RandomState(7)
    qa_tokens = rs.randint(0, args.vocab, (4, min(64, args.seq_length)))
    base_eng = registry.get("lm").scheduler.admitting_engine()
    quality = {}
    for variant in ("int8", "bf16"):
        eng = registry.get(f"lm_{variant}").scheduler.admitting_engine()
        quality[variant] = quality_delta(base_eng, eng, qa_tokens)
        if not np.isfinite(quality[variant]["ppl_variant"]):
            failures.append(f"{variant}: non-finite perplexity")
    # the head-to-head row: what does int8 cost RELATIVE to the bf16
    # variant an operator would otherwise deploy
    quality["int8_vs_bf16"] = quality_delta(
        registry.get("lm_bf16").scheduler.admitting_engine(),
        registry.get("lm_int8").scheduler.admitting_engine(), qa_tokens)
    summary["quant_quality"] = quality

    # ------------------------------------------------------ traffic + swap
    gen_args = argparse.Namespace(
        url=server.url, model="lm", mode="decode",
        prompt_len=args.prompt_len, max_new_tokens=args.max_new_tokens,
        temperature=0.0, top_k=0, vocab=args.vocab,
        requests=args.requests, concurrency=args.streams, rate=None,
        batch_sizes=[1], max_retries=4, retry_cap_s=2.0,
        deadline_ms=None, timeout_s=120.0, seed=0,
        priority_mix=parse_priority_mix("interactive=2,batch=1"))
    gen = LoadGen(gen_args, ())

    swap_state = {}

    def swapper():
        try:
            # wait for traffic to be genuinely mid-flight, then hot-swap
            time.sleep(0.5)
            body = json.dumps({"source": arch + "&seed=777"}).encode()
            t = time.perf_counter()
            r = urllib.request.urlopen(urllib.request.Request(
                server.url + "/v1/models/lm/swap", data=body,
                headers={"Content-Type": "application/json"}), timeout=300)
            swap_state["code"] = r.status
            swap_state["swap_s"] = round(time.perf_counter() - t, 2)
            swap_state["body"] = json.loads(r.read())
        except Exception as e:              # noqa: BLE001 — fail loud:
            # a silently-dead swapper reads as "swap never returned 200"
            # with no cause; the gate below reports swap_state verbatim
            swap_state["error"] = repr(e)

    swap_thread = threading.Thread(target=swapper, daemon=True,
                                   name="smoke-swapper")
    swap_thread.start()
    wall1, ok1 = gen.run_closed()
    swap_thread.join(timeout=300)
    if swap_state.get("code") != 200:
        failures.append(f"mid-traffic swap failed: {swap_state}")
    # phase 2: post-swap traffic (proves the new engine admits cleanly)
    wall2, ok2 = gen.run_closed()
    report = gen.report(wall1 + wall2, ok1 + ok2)
    summary["loadgen"] = report
    summary["swap"] = swap_state

    five_xx = sum(v for k, v in report["codes"].items()
                  if k.isdigit() and 500 <= int(k) < 600)
    if five_xx:
        failures.append(f"{five_xx} 5xx responses under decode traffic")
    if report["errors"]:
        failures.append(f"{report['errors']} streams failed "
                        f"({report['error_classes']})")

    # -------------------------------------- shared-prefix workload (HTTP)
    # the production shape prefix caching exists for: most prompts open
    # with one shared system prefix. Asserts the cache actually engaged.
    prefix_args = argparse.Namespace(
        url=server.url, model="lm_prefix", mode="decode",
        prompt_len=192, max_new_tokens=8, temperature=0.0, top_k=0,
        vocab=args.vocab, requests=max(16, args.requests),
        concurrency=3, rate=None, batch_sizes=[1], max_retries=4,
        retry_cap_s=2.0, deadline_ms=None, timeout_s=120.0, seed=3,
        priority_mix={}, prefix_mix={"shared": 3, "unique": 1},
        shared_prefix_len=160)
    pgen = LoadGen(prefix_args, ())
    pwall, pok = pgen.run_closed()
    preport = pgen.report(pwall, pok)
    summary["prefix_loadgen"] = preport
    hit_rate = (preport.get("prefix") or {}).get("cache_hit_rate")
    if preport["errors"]:
        failures.append(f"{preport['errors']} shared-prefix streams "
                        f"failed ({preport['error_classes']})")
    if not hit_rate or hit_rate <= 0:
        failures.append(f"prefix cache never hit on the shared-prefix "
                        f"workload (hit_rate={hit_rate})")

    # ------------------------------- cold-vs-hot TTFT (controlled, library)
    # sequential on an idle servable so the split measures prefill
    # compute, not queueing: cold = unique 448-token prompt (full
    # prefill under the default chunk budget), hot = 416 shared-prefix
    # tokens served from cached pages + a 32-token suffix chunk
    lmp = registry.get("lm_prefix")
    rs2 = np.random.RandomState(11)
    hot_prefix = rs2.randint(0, args.vocab, 416).tolist()
    _drain(lmp.generate(hot_prefix + rs2.randint(0, args.vocab, 32)
                        .tolist(), max_new_tokens=2))     # prime the cache
    cold_ttft, hot_ttft = [], []
    for _ in range(12):
        req = lmp.generate(rs2.randint(0, args.vocab, 448).tolist(),
                           max_new_tokens=2)
        _drain(req)
        cold_ttft.append(req.first_token_at - req.enqueued)
        req = lmp.generate(hot_prefix + rs2.randint(0, args.vocab, 32)
                           .tolist(), max_new_tokens=2)
        _drain(req)
        if req.cached_tokens != 416:
            failures.append(f"hot admission cached {req.cached_tokens} "
                            "of 416 shared-prefix tokens")
            break
        hot_ttft.append(req.first_token_at - req.enqueued)
    cold_p99, hot_p99 = _p99_ms(cold_ttft), _p99_ms(hot_ttft)
    summary["prefix_ttft"] = {"cold_p99_ms": cold_p99,
                              "hot_p99_ms": hot_p99,
                              "speedup": round(cold_p99 / hot_p99, 2)
                              if hot_p99 else None}
    if not hot_ttft or hot_p99 * 2 > cold_p99:
        failures.append(f"hot TTFT p99 {hot_p99}ms not >= 2x better "
                        f"than cold {cold_p99}ms")

    # ---------------------- long-prompt interferer ITL: chunking on vs off
    itl_chunked = _interferer_itl_p99(lmp, args.vocab,
                                      np.random.RandomState(13))
    itl_nochunk = _interferer_itl_p99(registry.get("lm_nochunk"),
                                      args.vocab,
                                      np.random.RandomState(13))
    summary["interferer_itl"] = {
        "chunked_p99_ms": itl_chunked, "nochunk_p99_ms": itl_nochunk,
        "chunk_tokens":
            lmp.scheduler.admitting_engine().prefill_chunk_tokens}
    if itl_chunked >= itl_nochunk:
        failures.append(
            f"chunked prefill did not improve interferer ITL p99 "
            f"({itl_chunked}ms chunked vs {itl_nochunk}ms monolithic)")

    # ------------------- speculative decoding A/B: parity + acceptance
    summary["spec_ab"], spec_failures = spec_ab(registry)
    failures.extend(spec_failures)

    # --------------------- tiered KV fabric: host-RAM spill tier parity
    # pool_pages barely over the floor (1 dump + one max-context
    # sequence) so retained zero-ref prefixes MUST demote to the pinned
    # host store when fresh admissions need pages; re-driving the first
    # prompt promotes them back and must reproduce its exact cold tokens
    from deeplearning4j_tpu_torch import monitor as _monitor
    pages_per_slot = args.seq_length // args.page_size
    registry.deploy_lm(
        "lm_spill", arch,
        decode=DecodeConfig(slots=2, page_size=args.page_size,
                            pool_pages=pages_per_slot + 4, spill_pages=64))
    lm_spill = registry.get("lm_spill")
    rs4 = np.random.RandomState(19)
    spill_prompts = [rs4.randint(0, args.vocab, 80).tolist()
                     for _ in range(3)]
    cold_tokens, _, _ = _stream(lm_spill, spill_prompts[0], n=8)
    for pr in spill_prompts[1:]:            # force demotion of prompt 0
        _stream(lm_spill, pr, n=8)
    hot_tokens, _, _ = _stream(lm_spill, spill_prompts[0], n=8)
    mtext = _monitor.prometheus_text()
    where = 'model="lm_spill"'
    spill = {k: _metric_sum_where(mtext, f"serving_kv_spill_{k}_total",
                                  where)
             for k in ("hits", "misses", "demotions", "promotions")}
    probes = spill["hits"] + spill["misses"]
    spill_hit_rate = round(spill["hits"] / probes, 4) if probes else 0.0
    summary["spill"] = dict(spill, hit_rate=spill_hit_rate,
                            parity=cold_tokens == hot_tokens)
    if spill["demotions"] <= 0:
        failures.append("spill tier never demoted a page — the tight "
                        "pool did not overflow into host RAM")
    if spill["hits"] <= 0 or spill["promotions"] <= 0:
        failures.append(
            f"re-driven prompt never hit the spill tier "
            f"(hits={spill['hits']} promotions={spill['promotions']})")
    if cold_tokens != hot_tokens:
        failures.append(
            f"greedy parity violated across the spill round-trip: "
            f"cold {cold_tokens} vs promoted {hot_tokens}")

    # -------------- prefix-affinity A/B: steering vs random over a fleet
    # two routers over the SAME 2-replica in-process fleet; each arm
    # drives its own disjoint page-aligned shared prefixes, so the only
    # difference the measured pass sees is the routing policy: affinity
    # steers repeat prefixes to the replica advertising ownership on its
    # /readyz heartbeat, random (p2c) rediscovers the cache by luck
    from deeplearning4j_tpu_torch.serving.fleet import (
        InProcessReplica, ReplicaSpec, ReplicaSupervisor, http_probe,
    )
    from deeplearning4j_tpu_torch.serving.router import (
        ResilientRouter, RouterServer,
    )
    fleet_cfg = DecodeConfig(slots=4, page_size=16, pool_pages=256,
                             spill_pages=128)

    def _replica_factory(i):
        return InProcessReplica(
            f"smoke-aff-{i}",
            ReplicaSpec([], lms=[("aff", arch_long)], decode=fleet_cfg,
                        device=str(device)))

    supervisor = ReplicaSupervisor(_replica_factory, 2,
                                   probe_interval_s=0.3,
                                   probe_timeout_s=10.0)
    supervisor.start()
    router_aff = ResilientRouter(supervisor.healthy, hedge=False,
                                 affinity=True)
    router_rand = ResilientRouter(supervisor.healthy, hedge=False,
                                  affinity=False)
    server_aff = RouterServer(router_aff, supervisor=supervisor)
    server_rand = RouterServer(router_rand)
    try:
        rs5 = np.random.RandomState(23)
        arm_p99 = {}
        for arm, url in (("affinity", server_aff.url),
                         ("random", server_rand.url)):
            # 416 = 26 full 16-token blocks: page-aligned, so the
            # leading-block digest chain is the ownership unit
            prefixes = [rs5.randint(0, args.vocab, 416).tolist()
                        for _ in range(4)]
            for pref in prefixes:           # cold pass seeds an owner
                _sse_ttft(url, "aff",
                          pref + rs5.randint(0, args.vocab, 32).tolist())
            # deterministic heartbeat: ownership advertisements land on
            # the replica handles before the measured pass
            for r in supervisor.replicas:
                http_probe(r, 10.0)
            samples = []
            for pref in prefixes:
                for _ in range(3):
                    # let the router's in-flight count on the previous
                    # stream decay: this pass measures steady-state
                    # routing policy, not the p2c guard racing the
                    # stream-teardown accounting
                    time.sleep(0.05)
                    ttft, _, _ = _sse_ttft(
                        url, "aff",
                        pref + rs5.randint(0, args.vocab, 32).tolist())
                    samples.append(ttft)
            arm_p99[arm] = _p99_ms(samples)
        owner_hits = _metric_sum_where(
            _monitor.prometheus_text(),
            "serving_router_affinity_requests_total", 'outcome="owner"')
        summary["affinity_ab"] = dict(arm_p99, owner_steered=owner_hits)
        if owner_hits <= 0:
            failures.append("affinity router never steered a request to "
                            "an ownership-advertising replica")
        if arm_p99["affinity"] >= arm_p99["random"]:
            failures.append(
                f"affinity routing did not beat random on repeat-prefix "
                f"TTFT p99 ({arm_p99['affinity']}ms affinity vs "
                f"{arm_p99['random']}ms random)")

        # the fleet-mode loadgen split: --prefix-mix through the
        # affinity router, per-replica cache-hit rates via X-Served-By
        fleet_args = argparse.Namespace(
            url=server_aff.url, model="aff", mode="decode",
            prompt_len=192, max_new_tokens=4, temperature=0.0, top_k=0,
            vocab=args.vocab, requests=16, concurrency=3, rate=None,
            batch_sizes=[1], max_retries=4, retry_cap_s=2.0,
            deadline_ms=None, timeout_s=120.0, seed=29,
            priority_mix={}, prefix_mix={"shared": 3, "unique": 1},
            shared_prefix_len=160)
        fgen = LoadGen(fleet_args, ())
        fwall, fok = fgen.run_closed()
        freport = fgen.report(fwall, fok)
        summary["fleet_prefix_loadgen"] = freport
        per_replica = (freport.get("prefix") or {}).get("per_replica")
        if freport["errors"]:
            failures.append(f"{freport['errors']} fleet prefix streams "
                            f"failed ({freport['error_classes']})")
        if not per_replica:
            failures.append("loadgen banked no per-replica cache-hit "
                            "split (X-Served-By missing from router "
                            "responses?)")
        elif max(v["cache_hit_rate"] for v in per_replica.values()) <= 0:
            failures.append(f"no replica saw a cache hit under the "
                            f"prefix-mix fleet workload: {per_replica}")
    finally:
        server_aff.stop()
        server_rand.stop()
        supervisor.stop()

    # ----------------------------------------------- compile-ledger proof
    metrics = urllib.request.urlopen(server.url + "/metrics",
                                     timeout=10).read().decode()
    compiles = _metric_sum(metrics, "serving_decode_compiles_total")
    warmups = _metric_sum(metrics, "serving_decode_warmup_runs_total")
    summary["ledger"] = {"compiles": compiles, "warmups": warmups}
    if compiles != warmups or compiles <= 0:
        failures.append(f"compile ledger imbalance: {compiles} compiles "
                        f"vs {warmups} warmups (a stream paid for a first run)")
    joins = _metric_sum(metrics, "serving_decode_preempted_joins_total")
    summary["preempted_joins"] = joins
    summary["kv_cache"] = {
        "hits": _metric_sum(metrics,
                            "serving_decode_kv_cache_hits_total"),
        "misses": _metric_sum(metrics,
                              "serving_decode_kv_cache_misses_total"),
        "evictions": _metric_sum(
            metrics, "serving_decode_kv_cache_evictions_total"),
    }
    if summary["kv_cache"]["hits"] <= 0:
        failures.append("serving_decode_kv_cache_hits_total never "
                        "incremented — prefix sharing did not engage")
    if joins <= 0:
        failures.append("no preempted joins recorded — streams never "
                        "joined a running batch (continuous batching "
                        "did not engage)")

    server.drain(timeout=30)

    dec = report.get("decode", {})
    summary["calib_cpu_ms"] = round((calib_start + _calibrate()) / 2, 3)
    summary["ok"] = not failures
    summary["failures"] = failures
    # bench-style rows: the decode throughput/latency series plus one
    # quality row per quantized variant
    summary["sweep"] = [{
        "mode": "decode", "on_gpu": device.type == "cuda", "batch": args.streams,
        "decode_tokens_sec": dec.get("decode_tokens_sec"),
        "decode_ttft_p99_ms": (dec.get("ttft_ms") or {}).get("p99"),
        "decode_itl_p99_ms": (dec.get("inter_token_ms") or {}).get("p99"),
        "streams": args.requests * 2,
        "zero_5xx": five_xx == 0,
        "compiles": compiles, "warmups": warmups,
        # slowest streams per class by client-minted trace_id: the
        # banked TTFT/ITL percentiles point at reproducible traces
        "slow_trace_ids": report.get("slowest"),
    }] + [{
        # the prefix-cache series: hit rate on the mixed shared/unique
        # HTTP workload, hot/cold TTFT from the controlled split (cold
        # banked for the ratio; only hot + hit rate are perf-gated)
        "mode": "decode_prefix", "on_gpu": device.type == "cuda", "batch": 3,
        "decode_cache_hit_rate": hit_rate,
        "decode_ttft_hot_p99_ms": hot_p99,
        "decode_ttft_cold_p99_ms": cold_p99,
        "streams": preport["requests"],
    }, {
        # head-of-line: short-stream ITL under a long-prompt interferer;
        # nochunk is the ungated reference the improvement is against
        "mode": "decode_interferer", "on_gpu": device.type == "cuda", "batch": 2,
        "decode_itl_interferer_p99_ms": itl_chunked,
        "decode_itl_interferer_nochunk_p99_ms": itl_nochunk,
    }, {
        # speculative A/B: acceptance rate is throughput-direction
        # gated; the spec-arm ITL rides the gated decode_itl_p99_ms
        # key in its own series; the plain-twin p99 is the ungated
        # reference the improvement was asserted against
        "mode": "decode_spec", "on_gpu": device.type == "cuda", "batch": 1,
        "decode_spec_acceptance_rate": summary["spec_ab"]["acceptance_rate"],
        "decode_itl_p99_ms": summary["spec_ab"]["itl_p99_ms"],
        "decode_spec_itl_base_p99_ms": summary["spec_ab"]["base_itl_p99_ms"],
        "streams": summary["spec_ab"]["streams"],
    }, {
        # tiered KV fabric: the host spill tier's admission hit
        # fraction under pool pressure (ratio-gated); demotion/promotion
        # counts ride along as ungated context
        "mode": "decode_spill", "on_gpu": device.type == "cuda", "batch": 1,
        "decode_spill_hit_rate": spill_hit_rate,
        "decode_spill_demotions": spill["demotions"],
        "decode_spill_promotions": spill["promotions"],
    }, {
        # prefix-affinity A/B over the 2-replica fleet: the affinity
        # arm's repeat-prefix TTFT p99 is latency-gated; the random arm
        # is the ungated reference the improvement was asserted against
        "mode": "decode_affinity", "on_gpu": device.type == "cuda", "batch": 2,
        "decode_affinity_ttft_hot_p99_ms": arm_p99["affinity"],
        "decode_affinity_ttft_random_p99_ms": arm_p99["random"],
        "streams": 24,
    }] + [{
        "mode": f"decode_quant_{variant}", "on_gpu": device.type == "cuda", "batch": None,
        **quality[variant],
    } for variant in sorted(quality)]
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())
