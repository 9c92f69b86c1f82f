"""`python -m deeplearning4j_tpu_torch.serving` — the serve CLI.

Counterpart of the JAX package's `serving/cli.py`.

Single-replica mode (default): stands up a ModelServer over predict
servables (``--model``) and LM decode servables (``--lm``) side by side
and runs until SIGTERM/SIGINT, then drains (stop admitting, flush
in-flight, exit 0). The LM servables take speculative decoding
(``--spec-*``, or ``@spec`` per servable), the host-RAM KV spill tier
(``--kv-spill-pages``) and a disaggregation role (``--kv-role``).

Fleet mode (``--replicas N``, N >= 2): a ReplicaSupervisor over N serving
replicas (subprocess by default — each its own crash domain and CUDA
context — or ``--replica-mode inprocess``) behind a ResilientRouter with
per-(replica, model) circuit breakers, priority-class shedding
(``--priority-classes``, the ``X-Priority`` header), hedged retries,
prefix-affinity routing and prefill/decode disaggregation
(``--kv-roles``, ``--disagg-*``). ``--port`` is then the ROUTER's port
(replicas bind ephemeral ports on localhost) and ``--device`` is passed
to every replica. ``--rollout-watch DIR`` tails a checkpoint directory's
``blessed.json`` (or its newest manifest entry) and canaries, then
promotes or rolls back, each new version; ``--autoscale-max`` scales the
fleet with the router's in-flight load. SIGTERM drains the fleet: the
router's /readyz goes 503, the rollout settles, in-flight work finishes,
then the replicas drain.

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
    python -m deeplearning4j_tpu_torch.serving --model lm=/ckpts/v1.zip \
        --replicas 3 --rollout-watch /ckpts --port 8500

The first line on stdout is one JSON object:
``{"serving": url, "models": [...], "endpoints": [...]}`` (fleet mode
adds ``"role": "router"``, the replicas, the priority classes, the
rollout and the autoscale band).

`build(args)` and `build_fleet(args)` do everything but the signal loop,
so a caller (a smoke run, a test) can stand the server or the fleet up
in-process; `drain_fleet` is the fleet's signal-time drain. Networks run
on ``--device`` (default cuda; there is no fallback to the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time


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
                          "both (single-replica mode; fleet mode assigns "
                          "roles with --kv-roles)")
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
    # ------------------------------------------------------ fleet mode
    fleet = p.add_argument_group("fleet mode")
    fleet.add_argument("--replicas", type=int, default=1,
                       help="N >= 2 supervises N replicas behind the "
                            "resilient router; 1 = plain single server")
    fleet.add_argument("--replica-mode", choices=("subprocess", "inprocess"),
                       default="subprocess",
                       help="subprocess = own crash domain and CUDA "
                            "context per replica (production); inprocess "
                            "= threads of this process (tests)")
    fleet.add_argument("--priority-classes",
                       default="interactive,standard,batch",
                       help="ordered priority ladder, highest first; "
                            "requests select via the X-Priority header")
    fleet.add_argument("--shed-floor", type=float, default=0.7,
                       help="fleet utilization at which the LOWEST class "
                            "starts shedding (higher classes shed at "
                            "evenly spaced higher thresholds)")
    fleet.add_argument("--per-replica-inflight", type=int, default=8,
                       help="router-side in-flight cap per replica (the "
                            "capacity unit behind shedding)")
    fleet.add_argument("--probe-interval-s", type=float, default=1.0)
    fleet.add_argument("--probe-timeout-s", type=float, default=2.0)
    fleet.add_argument("--unhealthy-after", type=int, default=3,
                       help="consecutive failed probes before a live "
                            "replica is presumed wedged and replaced")
    fleet.add_argument("--restart-budget", type=int, default=5,
                       help="restarts allowed per replica per 10 min "
                            "before it is marked dead (crash loop)")
    fleet.add_argument("--no-hedge", action="store_true",
                       help="disable hedged retries for straggler "
                            "predicts")
    fleet.add_argument("--kv-roles", default=None, metavar="R0,R1,...",
                       help="per-replica disaggregation roles (comma "
                            "list of prefill|decode|mixed, indexed by "
                            "replica); replicas beyond the list — "
                            "autoscaled ones included — serve 'mixed'. "
                            "At least one replica must be able to decode")
    fleet.add_argument("--no-affinity", action="store_true",
                       help="disable prefix-affinity routing (steering "
                            "same-prefix streams to the replica whose "
                            "heartbeat advertises ownership of the "
                            "prompt's leading KV block)")
    fleet.add_argument("--disagg-min-tokens", type=int, default=None,
                       help="prompts at least this many tokens long are "
                            "prefilled on a prefill-role replica and "
                            "their KV pages shipped to the decode "
                            "replica before the stream is routed "
                            "(default: disabled)")
    fleet.add_argument("--disagg-timeout-s", type=float, default=30.0,
                       help="per-leg timeout for the kv export/import "
                            "transfer; a missed deadline fails over to "
                            "local prefill on the decode replica")
    # ----------------------------------------------- continuous rollout
    ro = p.add_argument_group("continuous rollout")
    ro.add_argument("--rollout-watch", default=None, metavar="DIR",
                    help="checkpoint directory to tail for new versions; "
                         "enables the RolloutController (fleet mode only)")
    ro.add_argument("--rollout-model", default=None,
                    help="served model name the rollout swaps (default: "
                         "the first --model/--lm name)")
    ro.add_argument("--rollout-mode", choices=("blessed", "latest"),
                    default="blessed",
                    help="tail the eval-gated blessed.json manifest "
                         "(default) or the raw newest manifest entry")
    ro.add_argument("--rollout-observe-s", type=float, default=30.0,
                    help="canary observation window before the verdict")
    ro.add_argument("--rollout-poll-s", type=float, default=5.0,
                    help="how often the watcher re-reads the manifest")
    ro.add_argument("--rollout-canary-fraction", type=float, default=0.1,
                    help="bounded share of live traffic routed to the "
                         "canary replica (0 < f <= 0.5)")
    ro.add_argument("--rollout-min-requests", type=int, default=20,
                    help="minimum canary requests before a promote "
                         "verdict (insufficient traffic rejects)")
    ro.add_argument("--rollout-p99-floor-ms", type=float, default=10.0,
                    help="p99 regressions below this floor are noise, "
                         "not a verdict; raise it where the canary's "
                         "first requests pay a warm-up (cold swap)")
    # ------------------------------------------------------- autoscaling
    asc = p.add_argument_group("load-signal autoscaling")
    asc.add_argument("--autoscale-max", type=int, default=None,
                     metavar="N",
                     help="enable autoscaling up to N replicas "
                          "(--replicas is the floor); scale signal is "
                          "router in-flight vs healthy capacity "
                          "(--per-replica-inflight)")
    asc.add_argument("--autoscale-high", type=float, default=0.8,
                     help="utilization above this for consecutive ticks "
                          "scales up")
    asc.add_argument("--autoscale-low", type=float, default=0.25,
                     help="utilization below this for consecutive ticks "
                          "drains one replica (readyz-confirmed drain, "
                          "never a kill)")
    asc.add_argument("--autoscale-cooldown-s", type=float, default=10.0,
                     help="minimum seconds between scaling decisions")
    p.add_argument("--device", default="cuda",
                   help="torch device the networks run on (default cuda; "
                        "'cpu' must be asked for); in fleet mode every "
                        "replica's")
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
    """CLI decode knobs -> DecodeConfig (shared by all --lm servables)."""
    from deeplearning4j_tpu_torch.serving.decode import DecodeConfig
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


def _setup(args):
    """The part both modes share: turn on what the observability flags
    ask for (process-wide: the flight recorder, tracing) and parse the
    servables -> (buckets, specs, lm_specs, decode_cfg)."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.monitor import flight as flight_recorder

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
    return buckets, specs, lm_specs, _decode_config(args)


def build(args):
    """Deploy every --model and --lm and start the listener:
    (registry, server). Turns on what the observability flags ask for
    (process-wide: the flight recorder, tracing, the SLO engine)."""
    from deeplearning4j_tpu_torch.monitor import slo as slo_mod
    from deeplearning4j_tpu_torch.serving.registry import (
        ModelLoadError, ModelRegistry,
    )
    from deeplearning4j_tpu_torch.serving.server import ENDPOINTS, ModelServer
    from deeplearning4j_tpu_torch.util.platform import resolve_device

    buckets, specs, lm_specs, decode_cfg = _setup(args)
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


class Fleet:
    """What `build_fleet` stood up: the supervisor, the router and its
    HTTP face, the rollout controller (or None), the autoscale band (or
    None) and the priority classes."""

    def __init__(self, supervisor, router, server, rollout, autoscale,
                 classes):
        self.supervisor = supervisor
        self.router = router
        self.server = server
        self.rollout = rollout
        self.autoscale = autoscale
        self.classes = classes

    @property
    def url(self) -> str:
        return self.server.url


def _kv_roles(args, lm_specs) -> tuple:
    if not args.kv_roles:
        return ()
    roles = tuple(r.strip() for r in args.kv_roles.split(",") if r.strip())
    bad = sorted({r for r in roles
                  if r not in ("prefill", "decode", "mixed")})
    if bad:
        raise SystemExit(f"--kv-roles: unknown role(s) {bad} "
                         "(expected prefill|decode|mixed)")
    if (len(roles) >= args.replicas
            and all(r == "prefill" for r in roles[:args.replicas])):
        raise SystemExit("--kv-roles: every replica is 'prefill' — "
                         "at least one must be able to decode")
    if roles and not lm_specs:
        raise SystemExit("--kv-roles only applies to --lm servables")
    return roles


def build_fleet(args) -> Fleet:
    """--replicas N: launch the replicas (in parallel), wait until every
    one probes ready, then start the router (``--port`` is its port) and,
    with --rollout-watch, the rollout controller. Prints the router's
    announcement line. In subprocess mode this process creates no CUDA
    context: the device is only passed on."""
    from deeplearning4j_tpu_torch.monitor import slo as slo_mod
    from deeplearning4j_tpu_torch.serving.fleet import (
        AutoscaleConfig, InProcessReplica, ReplicaSpec, ReplicaSupervisor,
        SubprocessReplica,
    )
    from deeplearning4j_tpu_torch.serving.quantize import parse_variant
    from deeplearning4j_tpu_torch.serving.router import (
        ResilientRouter, RouterServer,
    )

    buckets, specs, lm_specs, decode_cfg = _setup(args)
    classes = tuple(c.strip() for c in args.priority_classes.split(",")
                    if c.strip())
    if not classes:
        raise SystemExit("--priority-classes must name at least one class")
    roles = _kv_roles(args, lm_specs)

    def _role(i: int) -> str:
        # replicas past the list (autoscaled growth included) serve mixed
        return roles[i] if i < len(roles) else "mixed"

    def _spec(i: int) -> ReplicaSpec:
        return ReplicaSpec(specs, buckets=buckets,
                           max_delay_ms=args.max_delay_ms,
                           queue_limit=args.queue_limit,
                           default_deadline_s=args.deadline_s,
                           enable_faults=args.enable_fault_injection,
                           lms=lm_specs, decode=decode_cfg,
                           trace_out=args.trace_out,
                           postmortem_dir=args.postmortem_dir,
                           flight=not args.no_flight,
                           flight_records=args.flight_records,
                           slo_availability=args.slo_availability,
                           slo_p99_ms=args.slo_p99_ms,
                           slo_sample_interval_s=args.slo_sample_interval_s,
                           slo_windows=args.slo_windows,
                           kv_role=_role(i), device=args.device)
    if args.replica_mode == "subprocess":
        for _, source in specs + lm_specs:
            base, _variant = parse_variant(source)
            if base.startswith("zoo:") or os.path.exists(base):
                continue
            raise SystemExit(f"fleet replicas cannot serve {source!r} "
                             "(need a path or zoo: name)")
        env = dict(os.environ)

        def factory(i):
            return SubprocessReplica(f"replica-{i}", _spec(i), env=env)
    else:
        def factory(i):
            return InProcessReplica(f"replica-{i}", _spec(i))

    autoscale = None
    if args.autoscale_max is not None:
        try:
            autoscale = AutoscaleConfig(
                min_replicas=args.replicas,
                max_replicas=args.autoscale_max,
                capacity_per_replica=args.per_replica_inflight,
                high_watermark=args.autoscale_high,
                low_watermark=args.autoscale_low,
                cooldown_s=args.autoscale_cooldown_s,
                drain_timeout_s=args.drain_timeout_s)
        except ValueError as e:
            raise SystemExit(f"--autoscale-*: {e}") from None
    rollout_model = None
    if args.rollout_watch is not None:
        model_names = [n for n, _ in specs + lm_specs]
        rollout_model = args.rollout_model or model_names[0]
    supervisor = ReplicaSupervisor(
        factory, args.replicas,
        probe_interval_s=args.probe_interval_s,
        probe_timeout_s=args.probe_timeout_s,
        unhealthy_after=args.unhealthy_after,
        restart_budget=args.restart_budget,
        autoscale=autoscale)
    try:
        supervisor.start()
    except Exception as e:                    # noqa: BLE001
        raise SystemExit(f"fleet launch failed: {e}") from None
    router = ResilientRouter(
        supervisor.healthy, classes=classes,
        shed_floor=args.shed_floor,
        per_replica_inflight=args.per_replica_inflight,
        hedge=not args.no_hedge, timeout_s=args.deadline_s,
        slo_p99_ms=args.slo_p99_ms,
        canary_fraction=args.rollout_canary_fraction,
        affinity=not args.no_affinity,
        disagg_min_tokens=args.disagg_min_tokens,
        disagg_timeout_s=args.disagg_timeout_s)
    slo_engine = _slo_setup(args, slo_mod.router_objectives(
        slo_p99_ms=args.slo_p99_ms,
        availability_target=args.slo_availability))
    server = RouterServer(router, supervisor=supervisor,
                          host=args.host, port=args.port,
                          slo_engine=slo_engine)
    rollout = None
    if rollout_model is not None:
        from deeplearning4j_tpu_torch.serving.rollout import RolloutController
        rollout = RolloutController(
            supervisor, router, args.rollout_watch, rollout_model,
            watch=args.rollout_mode,
            poll_interval_s=args.rollout_poll_s,
            observe_s=args.rollout_observe_s,
            min_canary_requests=args.rollout_min_requests,
            p99_floor_ms=args.rollout_p99_floor_ms)
        server.rollout = rollout
        rollout.start()
    endpoints = ["/v1/models", "/v1/fleet", "/healthz", "/readyz",
                 "/metrics"]
    if slo_engine is not None:
        endpoints += ["/v1/slo", "/v1/timeseries"]
    print(json.dumps({"serving": server.url, "role": "router",
                      "replicas": [r.describe() for r in
                                   supervisor.replicas],
                      "priority_classes": list(classes),
                      "endpoints": endpoints,
                      "rollout": (rollout.describe()
                                  if rollout is not None else None),
                      "autoscale": (None if autoscale is None else
                                    {"min": autoscale.min_replicas,
                                     "max": autoscale.max_replicas})}))
    sys.stdout.flush()
    return Fleet(supervisor, router, server, rollout, autoscale, classes)


def drain_fleet(fleet: Fleet, drain_timeout_s: float = 30.0):
    """The fleet's graceful drain, the single server's contract at fleet
    scope: flip the router's /readyz to 503 FIRST so the balancer stops
    sending, settle the rollout (a promotion must not race the teardown),
    give the balancer a moment to observe, let router-tracked in-flight
    work finish, then stop the replicas (each drains whatever is still
    inside it) and the router."""
    fleet.server.draining = True
    if fleet.rollout is not None:
        fleet.rollout.stop()
    grace = min(2.0, drain_timeout_s)
    time.sleep(grace)
    deadline = time.monotonic() + max(0.0, drain_timeout_s - grace)
    while time.monotonic() < deadline and any(
            r.inflight() for r in fleet.supervisor.replicas):
        time.sleep(0.1)
    fleet.supervisor.stop()
    fleet.server.stop()


def _wait_for_signal(action: str):
    stop = threading.Event()

    def _on_signal(signum, frame):
        print(json.dumps({"signal": signum, "action": action}),
              file=sys.stderr)
        stop.set()

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, _on_signal)
    stop.wait()


def _main_fleet(args) -> int:
    fleet = build_fleet(args)
    _wait_for_signal("fleet drain")
    drain_fleet(fleet, args.drain_timeout_s)
    if args.trace_out:
        # supervisor.stop() SIGTERMed the replicas: each drained and
        # saved its own segment next to the router's
        from deeplearning4j_tpu_torch import monitor
        n = monitor.save_trace(args.trace_out)
        print(json.dumps({"trace_out": args.trace_out, "events": n}),
              file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.replicas > 1:
        return _main_fleet(args)
    _, server = build(args)
    _wait_for_signal("drain")
    server.drain(timeout=args.drain_timeout_s)
    if args.trace_out:
        from deeplearning4j_tpu_torch import monitor
        n = monitor.save_trace(args.trace_out)
        print(json.dumps({"trace_out": args.trace_out, "events": n}),
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
