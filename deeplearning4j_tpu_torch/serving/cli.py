"""`python -m deeplearning4j_tpu_torch.serving` — the serve CLI.

Counterpart of the JAX package's `serving/cli.py`, single-replica mode:
stands up a ModelServer over predict servables (``--model``) and LM
decode servables (``--lm``) side by side and runs until SIGTERM/SIGINT,
then drains (stop admitting, flush in-flight, exit 0). The LM servables
take speculative decoding (``--spec-*``, or ``@spec`` per servable), the
host-RAM KV spill tier (``--kv-spill-pages``) and a disaggregation role
(``--kv-role``). The fleet mode's flags (``--kv-roles``, ``--disagg-*``)
are ROADMAP A.14 and exit.

Observability, as in the reference: the flight recorder is on for a
served process (``--no-flight`` turns it off, ``--flight-records`` sizes
its ring, ``--postmortem-dir`` receives its automatic postmortems),
``--trace-out`` records spans and writes the trace on drain, any
``--slo-*`` objective (``--slo-p99-ms``, ``--slo-availability``) starts
the time-series ring (``--slo-sample-interval-s``) and the burn-rate
engine (``--slo-windows``) behind ``GET /v1/slo`` and
``/v1/timeseries``, and ``--enable-fault-injection`` exposes
``/v1/faults`` and honours ``$DL4J_CUDA_SERVING_FAULTS``. ``GET
/metrics`` is always served.

Usage:
    python -m deeplearning4j_tpu_torch.serving \
        --model 'lm=zoo:TransformerLM?seq_length=2048&n_embd=512&attention_impl=flash' \
        --port 8500 --buckets 1,4 --max-delay-ms 5
    python -m deeplearning4j_tpu_torch.serving \
        --lm 'gen=zoo:TransformerLM?seq_length=2048&n_embd=512' \
        --lm 'gen8=zoo:TransformerLM?seq_length=2048&n_embd=512@int8' \
        --decode-slots 4 --decode-page-size 16

The first line on stdout is one JSON object:
``{"serving": url, "models": [...], "endpoints": [...]}``.

`build(args)` does everything but the signal loop, so a caller (a smoke
run, a test) can stand the server up in-process. Networks run on
``--device`` (default cuda; there is no fallback to the CPU).
"""
from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.serving",
        description="Model server on PyTorch/CUDA: named servables, "
                    "shape-bucketed batching, admission control")
    p.add_argument("--model", action="append", default=[],
                   metavar="NAME=SOURCE",
                   help="predict servable to deploy; SOURCE is a model zip "
                        "or zoo:<Arch> (constructor kwargs ride a query "
                        "string: zoo:TransformerLM?n_layers=2). Repeatable.")
    dec = p.add_argument_group("LM decode servables")
    dec.add_argument("--lm", action="append", default=[],
                     metavar="NAME=SOURCE",
                     help="decode servable (continuous-batching token "
                          "generation, POST .../generate). Same SOURCE "
                          "forms as --model; an @int8 / @bf16 suffix "
                          "serves a post-training-quantized variant. "
                          "Repeatable.")
    dec.add_argument("--decode-slots", type=int, default=4,
                     help="fixed in-flight decode batch positions")
    dec.add_argument("--decode-page-size", type=int, default=16,
                     help="tokens per KV-cache page")
    dec.add_argument("--decode-max-context", type=int, default=None,
                     help="KV capacity per sequence (default: the "
                          "model's seq_length)")
    dec.add_argument("--decode-pool-pages", type=int, default=None,
                     help="physical KV pages in the pool (default "
                          "slots*max_context/page_size: no "
                          "oversubscription)")
    dec.add_argument("--decode-queue-limit", type=int, default=64,
                     help="pending-join bound (full -> 429)")
    dec.add_argument("--prefill-buckets", default=None,
                     help="prefill sequence-length ladder (comma ints, "
                          "page-aligned; default: geometric up to "
                          "max_context)")
    dec.add_argument("--prefill-chunk-tokens", type=int, default=None,
                     help="per-scheduler-tick prefill-token budget: long "
                          "uncached prompt suffixes run in chunks of at "
                          "most this many tokens between decode steps "
                          "(default: 4 pages; 0 disables chunking)")
    dec.add_argument("--no-prefix-cache", action="store_true",
                     help="disable copy-on-write KV prefix sharing across "
                          "requests with a common prompt prefix")
    dec.add_argument("--spec-draft", default=None, metavar="SRC",
                     help="turn on speculative decoding for every --lm "
                          "servable: 'int8'/'bf16' self-draft the target "
                          "through a quantized variant of its own "
                          "params; any other value loads a servable "
                          "source with the SAME vocab (a mismatch is a "
                          "deploy-time error). Per-servable override: "
                          "the @spec source suffix")
    dec.add_argument("--spec-k", type=int, default=4,
                     help="draft tokens proposed per verify round")
    dec.add_argument("--spec-accept-floor", type=float, default=0.4,
                     help="rolling acceptance-rate floor below which a "
                          "stream stops speculating (plain decode)")
    dec.add_argument("--spec-window", type=int, default=8,
                     help="rounds in the per-stream acceptance window")
    dec.add_argument("--spec-draft-pool-pages", type=int, default=None,
                     help="KV pages in the draft engine's own pool "
                          "(default: sized like the target's)")
    dec.add_argument("--kv-spill-pages", type=int, default=0,
                     help="host-RAM KV spill-tier capacity in pages (0 "
                          "disables): zero-ref retained prefix pages "
                          "demote into host memory instead of being "
                          "dropped, and promote back on a prefix hit")
    dec.add_argument("--kv-role", choices=("prefill", "decode", "mixed"),
                     default="mixed",
                     help="disaggregation role this server advertises on "
                          "/readyz: 'prefill' computes KV and ships pages "
                          "(POST .../kv/export), 'decode' lands them (POST "
                          ".../kv/import) and streams tokens, 'mixed' does "
                          "both")
    # the reference's fleet-mode KV flags: accepted so a reference command
    # line parses, refused at build()
    fleet = p.add_argument_group("fleet mode (not yet ported)")
    fleet.add_argument("--kv-roles", default=None, metavar="R0,R1,...",
                       help="per-replica disaggregation roles: ROADMAP "
                            "A.14, not yet ported")
    fleet.add_argument("--disagg-min-tokens", type=int, default=None,
                       help="router-side disaggregation threshold: ROADMAP "
                            "A.14, not yet ported")
    fleet.add_argument("--disagg-timeout-s", type=float, default=None,
                       help="router-side transfer timeout: ROADMAP A.14, "
                            "not yet ported")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (0.0.0.0 behind a load balancer)")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--buckets", default="1,8,32,128",
                   help="batch-size bucket ladder (comma-separated)")
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="batching coalescing deadline")
    p.add_argument("--queue-limit", type=int, default=256,
                   help="admission-control queue bound (full -> 429)")
    p.add_argument("--deadline-s", type=float, default=30.0,
                   help="default per-request deadline (expired -> 504)")
    p.add_argument("--drain-timeout-s", type=float, default=30.0,
                   help="max time to flush in-flight work on SIGTERM")
    p.add_argument("--enable-fault-injection", action="store_true",
                   help="expose POST /v1/faults (chaos testing; wedge "
                        "probes / predicts of THIS process) and honor "
                        "$DL4J_CUDA_SERVING_FAULTS. Never on by default.")
    obs = p.add_argument_group("observability")
    obs.add_argument("--trace-out", default=None, metavar="PATH",
                     help="enable span tracing and save the Chrome/"
                          "Perfetto trace here on drain")
    obs.add_argument("--postmortem-dir", default=None, metavar="DIR",
                     help="flight-recorder SLO postmortems (5xx, wedge, "
                          "p99 breach, burn-rate alerts) are auto-dumped "
                          "here as JSON")
    obs.add_argument("--flight-records", type=int, default=512,
                     help="per-request flight-recorder ring capacity")
    obs.add_argument("--no-flight", action="store_true",
                     help="disable the flight recorder (on by default "
                          "for served processes; the ring is bounded "
                          "host memory, never on the device path)")
    obs.add_argument("--slo-p99-ms", type=float, default=None,
                     help="latency SLO: 99%% of requests must finish "
                          "under this; breaches fire the SLO engine's "
                          "burn-rate alert (reason p99_breach) and an "
                          "automatic postmortem")
    obs.add_argument("--slo-availability", type=float, default=None,
                     metavar="TARGET",
                     help="availability SLO target (e.g. 0.999). Any "
                          "--slo-* flag enables the in-process time-"
                          "series ring + multi-window burn-rate "
                          "alerting; verdicts on GET /v1/slo, firings "
                          "trip flight postmortems")
    obs.add_argument("--slo-sample-interval-s", type=float, default=5.0,
                     help="time-series sampling interval while an "
                          "--slo-* objective is active")
    obs.add_argument("--slo-windows", default=None, metavar="FL,FS,SL,SS",
                     help="override the burn-rate windows (seconds): "
                          "fast-long,fast-short,slow-long,slow-short "
                          "(default 3600,300,21600,1800)")
    p.add_argument("--device", default="cuda",
                   help="torch device the networks run on (default cuda; "
                        "'cpu' must be asked for)")
    return p


def _parse_specs(values, flag="--model"):
    out = []
    for spec in values:
        name, sep, source = spec.partition("=")
        if not sep or not name or not source:
            raise SystemExit(f"{flag} expects NAME=SOURCE, got {spec!r}")
        out.append((name, source))
    return out


def _decode_config(args):
    """CLI decode knobs -> DecodeConfig (shared by all --lm servables).
    The fleet flags, not yet ported, exit here."""
    from deeplearning4j_tpu_torch.serving.decode import DecodeConfig
    fleet = [f for f in ("kv_roles", "disagg_min_tokens", "disagg_timeout_s")
             if getattr(args, f) is not None]
    if fleet:
        raise SystemExit(f"--{fleet[0].replace('_', '-')}: the serving "
                         "fleet (router, replicas, disaggregated routing) "
                         "is ROADMAP A.14, not yet ported to the PyTorch "
                         "package")
    if args.kv_spill_pages < 0:
        raise SystemExit("--kv-spill-pages must be >= 0")
    prefill = None
    if args.prefill_buckets:
        try:
            prefill = tuple(int(b) for b in args.prefill_buckets.split(",")
                            if b)
        except ValueError:
            raise SystemExit("--prefill-buckets must be comma-separated "
                             f"ints, got {args.prefill_buckets!r}") from None
    return DecodeConfig(slots=args.decode_slots,
                        page_size=args.decode_page_size,
                        max_context=args.decode_max_context,
                        pool_pages=args.decode_pool_pages,
                        prefill_buckets=prefill,
                        queue_limit=args.decode_queue_limit,
                        prefix_cache=not args.no_prefix_cache,
                        prefill_chunk_tokens=args.prefill_chunk_tokens,
                        spec_draft=args.spec_draft,
                        spec_k=args.spec_k,
                        spec_accept_floor=args.spec_accept_floor,
                        spec_window=args.spec_window,
                        spec_draft_pool_pages=args.spec_draft_pool_pages,
                        spill_pages=args.kv_spill_pages or None)


def _slo_setup(args, objectives):
    """Enable the time-series ring + SLO engine from --slo-* flags.
    Returns the engine (None when no --slo-* flag was given)."""
    if not objectives:
        return None
    from deeplearning4j_tpu_torch.monitor import slo, timeseries
    rules = slo.DEFAULT_RULES
    if args.slo_windows:
        try:
            fl, fs, sl, ss = (float(x)
                              for x in args.slo_windows.split(","))
        except ValueError:
            raise SystemExit("--slo-windows expects 4 comma-separated "
                             f"seconds, got {args.slo_windows!r}") from None
        # keep the workbook burn thresholds, scale the flap-suppression
        # hold with the short windows
        rules = (slo.BurnRule("page", fl, fs, 14.4,
                              keep_firing_s=max(2.0, fs / 2)),
                 slo.BurnRule("ticket", sl, ss, 6.0,
                              keep_firing_s=max(2.0, ss / 2)))
    timeseries.enable_timeseries(interval_s=args.slo_sample_interval_s)
    return slo.enable_slo(objectives, rules=rules)


def build(args):
    """Deploy every --model and --lm and start the listener:
    (registry, server). Turns on what the observability flags ask for
    (process-wide: the flight recorder, tracing, the SLO engine)."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.monitor import flight as flight_recorder
    from deeplearning4j_tpu_torch.monitor import slo as slo_mod
    from deeplearning4j_tpu_torch.serving.registry import (
        ModelLoadError, ModelRegistry,
    )
    from deeplearning4j_tpu_torch.serving.server import ENDPOINTS, ModelServer
    from deeplearning4j_tpu_torch.util.platform import resolve_device

    # observability defaults for served processes: the flight recorder is
    # ON (bounded host-side ring; the zero-cost contract only governs the
    # library default), span tracing only when --trace-out asks for it
    if not args.no_flight:
        flight_recorder.enable_flight(capacity=args.flight_records,
                                      dump_dir=args.postmortem_dir)
    if args.trace_out:
        monitor.enable_tracing()

    try:
        buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    except ValueError:
        raise SystemExit(f"--buckets must be comma-separated ints, got "
                         f"{args.buckets!r}") from None
    specs = _parse_specs(args.model)
    lm_specs = _parse_specs(args.lm, "--lm")
    if not specs and not lm_specs:
        raise SystemExit("deploy at least one servable (--model/--lm)")
    names = [n for n, _ in specs + lm_specs]
    if len(set(names)) != len(names):
        raise SystemExit(f"duplicate servable name in {names}")
    decode_cfg = _decode_config(args)
    registry = ModelRegistry(device=resolve_device(args.device))
    for name, source in specs:
        try:
            served = registry.deploy(name, source, buckets=buckets,
                                     max_delay_ms=args.max_delay_ms,
                                     queue_limit=args.queue_limit)
        except ModelLoadError as e:
            registry.shutdown(drain=False)
            raise SystemExit(f"cannot deploy {name!r}: {e}") from None
        print(json.dumps({"deployed": name,
                          "input_shape": list(served.input_shape),
                          "buckets": list(served.batcher.buckets),
                          "device": str(served.model.device),
                          "warmup_s": served.warmup_seconds}),
              file=sys.stderr)
    for name, source in lm_specs:
        try:
            served = registry.deploy_lm(name, source, decode=decode_cfg)
        except ModelLoadError as e:
            registry.shutdown(drain=False)
            raise SystemExit(f"cannot deploy LM {name!r}: {e}") from None
        print(json.dumps({"deployed": name, "kind": "lm",
                          "vocab_size": served.vocab,
                          "max_context": served.max_context,
                          "device": str(served.model.device),
                          "warmup_s": served.warmup_seconds}),
              file=sys.stderr)
    slo_engine = _slo_setup(args, slo_mod.server_objectives(
        slo_p99_ms=args.slo_p99_ms,
        availability_target=args.slo_availability))
    server = ModelServer(registry, host=args.host, port=args.port,
                         default_deadline_s=args.deadline_s,
                         kv_role=args.kv_role,
                         enable_faults=args.enable_fault_injection,
                         slo_engine=slo_engine)
    endpoints = [e for e in ENDPOINTS
                 if (e != "/v1/faults" or args.enable_fault_injection)
                 and (e not in ("/v1/slo", "/v1/timeseries")
                      or slo_engine is not None)]
    print(json.dumps({"serving": server.url, "models": registry.names(),
                      "endpoints": endpoints}))
    sys.stdout.flush()
    return registry, server


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _, server = build(args)
    stop = threading.Event()

    def _on_signal(signum, frame):
        print(json.dumps({"signal": signum, "action": "drain"}),
              file=sys.stderr)
        stop.set()

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, _on_signal)
    stop.wait()
    server.drain(timeout=args.drain_timeout_s)
    if args.trace_out:
        from deeplearning4j_tpu_torch import monitor
        n = monitor.save_trace(args.trace_out)
        print(json.dumps({"trace_out": args.trace_out, "events": n}),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
