"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernel checks only (fwd, bwd)

Phases, each printing one JSON line; any failure exits non-zero with no
result line:

1. device  — requires CUDA; prints the card's name and power limit as
             nvidia-smi gives them.
2. build   — builds every kernel of the port from ops/csrc with nvcc (one
             process per source, all started together) and prints the
             build seconds and ptxas's register/spill report.
3. kernels — holds each kernel against its plain PyTorch version on the
             card, on the same inputs: O and LSE, bf16 atol/rtol 2e-2,
             f32 atol 1e-4; and two forward calls on the same inputs must
             give bitwise-equal O and LSE (both routes). Then times the
             kernel, the plain version and torch's
             scaled_dot_product_attention (a yardstick only; the port
             never calls it) at the repo's attention bench shape and at
             the main path's shape, beside the least time the card could
             take for the same work: each call by CUDA events
             (`kernel_ms`, `library_ms`: the wrapper's host work
             included), and the kernels alone by torch.profiler's kernel
             events (`kernel_device_ms`, `library_device_ms`).
   Then the same for the two backward kernels (dQ, dK/dV) against the
             plain backward, on the forward kernel's outputs and random
             cotangents (a g_lse != 0 case included): f32 atol 1e-4, bf16
             atol/rtol 3e-2; and two backward calls on the same inputs
             must give bitwise-equal gradients (both routes). Each
             backward kernel is timed alone, beside the plain backward
             (all three gradients) and SDPA's backward ((forward +
             backward) - forward). Every timing row carries its roofline
             share and achieved TFLOP/s.
4. serve   — the port's predict path, through the entry points a user
             calls: serving.cli.build() stands up the HTTP server over a
             full-width TransformerLM (random weights from its seed) with
             flash attention; at least 8 POST /v1/models/lm/predict
             requests go over a real socket as .npy. Every answer is
             checked (200, shape, finite, rows sum to 1), the kernel
             launch count must equal n_layers x the batcher's dispatches
             (no backward launch), and one answer must match the same
             network run with the plain attention version on the card.
4b. generate — the port's token-generation path: serving.cli.build()
             with three LM servables (the same full-width LM, and its
             @int8 and @bf16 variants; 4 slots, 16-token pages), then 12
             POST /v1/models/{name}/generate over the socket, SSE and
             JSON mixed: prompts of 17, 100, 700 and 1500 tokens one at a
             time (1500 in budgeted prefill chunks, its first 1024 tokens
             then a prefix-cache hit for the next prompt), one request on
             each variant, then four concurrent streams (one sampled at
             T = 1, top-k 5) and a late joiner whose first token must
             come before the first stream is done. Every greedy token must
             be the argmax of the served network's own output() (which
             runs the flash kernel; near-ties under 1e-4 are counted) and
             every sampled one in its top 5; no flash kernel may launch on
             the request path and no program may first run there. Then
             the sampler's distribution on the card, quality_delta of
             each variant, engine.step() by CUDA events with four live
             slots, a profiled window of steps (launches per step, idle
             share, host time by operator), and the host-device
             synchronisations of a greedy and a sampling step (at most
             one each: the sampled tokens' copy back). Every decode
             program replays a CUDA graph captured in warm(): one replay
             a step; each servable's programs, graph pool bytes and
             capture seconds are reported.
5. train   — the port's training path: the same full-width LM saved as a
             zip, and train.cli.main (`--mode single`, batch 4, 2 epochs
             of a seeded 32-sequence token set = 16 steps) in-process.
             The run must exit 0 with the reference's result line, finite
             and falling scores, exactly n_layers x 16 launches of each
             kernel, and an output zip that reloads with its 16 iterations
             and updaterState.bin; one batch's gradients through the
             kernels must match those with the plain attention swapped in
             (per-leaf error <= 1e-4 of the leaf's largest gradient).
             Then 6 more steps are timed by CUDA events, and 2 more are
             profiled (torch.profiler: device time by kernel category and
             the device's idle share of the host's wall time).

6. resnet  — ResNet-50 through the port's ComputationGraph (no flash
             kernel on this path: convolution, pooling, batch norm and
             the residual adds go to PyTorch, so cuDNN, as the reference
             leaves them to XLA). (a) card against CPU: the zoo's
             ResNet50(num_classes=10, input_shape=(64, 64, 3)) from one
             zip, batch 4: output() within 1e-4 in f32 (TF32 off), and one
             fit step, in f32 (score rtol 1e-4) and in f64 (every leaf
             within 1e-4 of its largest update, BN state within 1e-8);
             (b) the entry point: the full zoo ResNet50() (224², 1000
             classes) saved with save_model, 64 seeded images in an npz,
             train.cli.main(--mode single --batch-size 32) = 2 steps, the
             output zip reloaded; (c) timed at the reference bench's shape
             (bench.py:209: batch 128, 224², Nesterovs(0.1, 0.9), l2
             1e-4, one seeded batch on the card), f32 and bf16 compute:
             per-call fit steps (3 to warm up, 10 timed by CUDA events),
             imgs/s, TFLOP/s at 24.6 GFLOP per image, launches and
             host-device syncs per step, device ms by category (two steps
             split at syncs into forward / backward / optimizer), idle
             share, peak memory; over 20 f32 steps on the one batch with
             cuDNN's deterministic algorithms (a trajectory that repeats
             from run to run) the loss must fall.
7. fit_graph — the reference's production fit loop (bench.py:320-345's
             "fit" mode). (a) ResNet-50 at the bench shape through
             ComputationGraph.fit(iterator, scan_steps=10): uint8 pixels,
             ImagePreProcessingScaler applied on the card, prefetch on,
             two chunks a fit; per-call (scan_steps=1, same pipeline)
             first, then the replayed CUDA graph, f32 and bf16: fit and
             chunk wall ms, step ms, imgs/s, TFLOP/s, host launch calls,
             graph launches and device kernels a step, device busy ms
             and idle share (torch.profiler, one chunk), peak memory,
             and the host-device syncs of a fit by site (none inside a
             chunk's dispatch, one loss fetch a chunk). (b) the full-width LM
             through fit(scan_steps=8) over 16 steps, per-call and graph:
             step ms, the same profile (one chunk); each captured step
             must run each flash kernel n_layers times (the profiler's
             kernel events).
             (c) equality on the card, graph against per-call from one
             init: the LM (16 steps) bitwise, a small MLP with dropout
             0.5 bitwise, ResNet50 at 64² (batch 4, two chunks of 3,
             cuDNN deterministic) bitwise or within 1e-5 of each update;
             in f64 at 64²: one update of accumulate_steps=2, card
             against CPU, within 1e-12 of the update, and scan_steps=2
             over two chunks bitwise equal to per-call steps on the card
             (both reported against the CPU after 4 updates); evaluate()
             of one network on the card and the CPU with equal accuracy
             and confusion matrix.
8. rnn     — the recurrent path (no hand-written kernel: the LSTM step
             is PyTorch ops, cuBLAS for the GEMMs). (a) card against CPU:
             an LSTM + GravesLSTM + Bidirectional(LSTM) net from one zip,
             output() and a masked forward in f32 within 1e-5, two tbptt
             chunks in f64 (a masked tail across the boundary) within
             1e-10 of each leaf's largest update, and check_gradients in
             f64 on the card for a masked GravesLSTM; (b) the entry
             point: the zoo's full-width TextGenerationLSTM (47
             characters, 2 x 256, tbptt 50, Adam 1e-3, clip 5) at
             sequences of 1000 characters, saved with save_model, 64
             seeded sequences, train.cli.main(--mode single --batch-size
             32) = 2 batches x 20 chunks = 40 iterations, the result
             line, the reloaded zip and a falling loss; then its tbptt
             chunk steps on one batch on the card: chunk ms by CUDA
             events, chars/s, syncs a chunk, peak memory, and two
             chunks profiled (launches, device busy, idle share); (c)
             streaming: rnn_time_step primed with 50 characters, then
             200 one-step calls at batch 1, equal to output() within
             1e-5, ms a call; (d) bench.py's char-LSTM at its chip sizes
             (2 x LSTM(200), 77 characters, T = 50, batch 64, f32)
             through fit(scan_steps=1) then fit(scan_steps=10): step ms,
             chars/s, host launch calls and device kernels a step, idle
             share, syncs by site, and the graph steps bitwise equal to
             the per-call steps from one init; (e) torch.nn.LSTM (cuDNN)
             forward and backward at (d)'s shape, a yardstick the port
             never calls. The kernel table's `launches_by_path` gains
             "rnn", which must read 0 for every flash kernel.
9. zoo     — detection, the VAE and the rest of the zoo (no hand-written
             kernel: convolution, pooling, batch norm and the YOLO loss
             are PyTorch ops, cuDNN for the convolutions). (a) card
             against CPU: TinyYOLO (3 classes, 64²) from one zip, batch 4
             with 1-2 boxes an image, output() within 1e-4 in f32 (TF32
             off) and the score within rtol 1e-4; in f64 the training
             score and gradients within 1e-10 and one Adam fit step
             within 1e-6 of each leaf's largest update (Adam's first step
             amplifies entries with |g| near its eps), the batch norm
             state within 1e-10; a VAE's negative ELBO with one fixed
             noise and its gradients in f64 within 1e-10; check_gradients
             in f64 on the card for a YOLO head and a VAE net; (b) the
             entry point at full width: the zoo's YOLO2() (608², 80
             classes, 5 anchors, a 19x19 grid) saved with save_model, 32
             seeded images with 1-4 boxes each in an npz,
             train.cli.main(--mode single --batch-size 16) = 2 steps, the
             output zip reloaded, its output() on 4 images through
             decode_detections and non_max_suppression; (c) YOLO2 at
             608², batch 16, Adam(1e-3), one seeded batch: per-call f32
             and bf16 steps (3 warm, 10 timed by CUDA events), imgs/s,
             TFLOP/s at 3x the forward GFLOP counted from the conv
             shapes, host launch calls and device kernels a step, syncs a
             step, device ms by category, the loss's own time, idle
             share, peak memory; then bf16 fit(scan_steps=10) beside
             per-call fit over uint8 images with the scaler on the card,
             and the graph's steps bitwise equal to per-call steps from
             one init (cuDNN deterministic); over 20 deterministic f32
             steps the loss must fall; (d) VGG16 at 224², batch 64, f32
             and bf16: step ms, imgs/s, TFLOP/s, device ms by category,
             peak memory; (e) AlexNet, VGG19, GoogLeNet, Darknet19,
             TinyYOLO, InceptionResNetV1, FaceNetNN4Small2 and UNet at
             their default inputs, batch 8: one fit step with a finite
             score and output() of the conf's output shape, a second step
             timed; (f) LeNet through train.cli.main(--dataset mnist
             --synthetic-data --mode single --batch-size 64) = 32 steps,
             then AutoEncoder -> VAE -> OutputLayer on the flattened
             synthetic MNIST through fit_pretrain and fit: the VAE's
             negative ELBO on one batch with one fixed noise must be
             lower after pretraining. `launches_by_path` gains "zoo",
             which must read 0 for every flash kernel.
10. lm_ops — the rest of the LM serving runtime, through
             serving.cli.build() over the socket: the full-width LM as
             the predict servable `lm`, the LM servable `gen` and
             `spec=<LM>@spec:draft=int8,k=4`. (a) With 4 greedy streams
             of 64 tokens in flight, POST /v1/models/gen/swap to a zip
             of the same architecture from another seed: every answer
             200, each stream's tokens the argmax of the version that
             admitted it, the next request on version 2, a rollback
             serving version 1's tokens again, a swap to a vocab-512 LM
             refused with a 4xx while gen answers; the same swap and
             rollback on `lm`, whose answers follow the network, with
             n_layers flash-forward launches a batcher dispatch (warms
             included) and no backward launch; swap seconds and peak
             memory with two versions resident. (b) The port's
             CheckpointManager writes two checkpoints of a small LM, the
             newest is corrupted, and the registry serves the older.
             (c) Greedy prompts of 17, 100 and 700 tokens (64 new) on
             `spec` bitwise equal to `gen`'s; a sampled stream (T = 1,
             top-k 5) inside the target's top 5; one k-drafted verify
             bitwise equal to k+1 sequential steps at engine level; the
             acceptance rate, rounds, host syncs a round (at most 1),
             launches a round and, on four concurrent streams, ITL and
             tokens/s beside `gen`; no program first run on the request
             path. (d) A pool of 129 pages and a 128-page host tier: a
             1024-token prompt's pages demote under a 2032-token prompt
             and promote back on its repeat (>= 1008 cached tokens), the
             tokens `gen`'s; ms a page demoted and promoted. (e) Two
             servers, --kv-role prefill and decode: the 1024-token prefix
             exported from one and imported into the other, whose
             generate reports 1024 cached tokens and the first server's
             tokens; a corrupted blob answers 400 and the server still
             serves; bytes and ms of each. (f) Fault C.8: the decode
             smoke's speculative A/B (`tools/decode_smoke.spec_ab`, its
             1-layer 16-wide LM, 2 slots, @spec:draft=int8,k=12, 52
             greedy streams of 120 tokens): both per-stream mean ITL
             p99s, the acceptance, 0 mismatched streams, and the round
             split into draft replay, verify replay and host ms beside a
             plain step's ms (not gated on spec < plain: PERF.md §6, PR
             23). `launches_by_path` gains
             "lm_ops": flash forward > 0 (the predict servable), dQ and
             dK/dV 0.
11. data_plane — the shard data plane (no hand-written kernel: shards,
             the ring and the record readers are numpy in worker
             processes). (a) 1280 seeded uint8 images (224², int labels,
             1000 classes) written through ShardWriter (bytes and convert
             seconds; the phase fails naming the bytes if the temporary
             directory cannot hold them), streamed by
             MultiProcessDataSetIterator(ShardBatchLoader(dir, 128)) with
             the default worker count (it fails if that is 0, e.g. under
             DL4J_CUDA_ETL_WORKERS=0) and ImagePreProcessingScaler on the
             pipe, into ComputationGraph.fit(scan_steps=10) of the zoo's
             ResNet50(), f32 then bf16 compute: a warm epoch, then
             DATA_ROUNDS epochs each from memory (ExistingDataSetIterator
             over the same batches), from the ring with copy=True and
             with copy=False, in turns: step ms, imgs/s, the train loop's wait
             for its batches (the first chunk's apart), the ring's fetch
             wait, the workers' decode
             ms, host ms to stage one batch (its pinned copy), the ring's
             bytes in /dev/shm, device busy ms and idle share (one
             profiled epoch each from memory and the ring), peak memory,
             and, for each ring mode, the stage that sets the pace: the
             device unless its median step trails memory's by more than
             memory's run-to-run spread (0 over one round), else the
             fetch wait or the
             staging, whichever is longer a batch. (b) the train phase's token set (32
             sequences of 2048, next-token labels one-hot uint8) as
             shards, through the ring (2 workers) into the full-width
             LM's fit(scan_steps=8) over 16 steps: the loss falls, the
             parameters are bitwise those of the same batches from the
             in-process ShardDataSetIterator, and a profiled second fit
             runs each flash kernel n_layers times a step. (c) ResNet50
             at 64², batch 4, cuDNN deterministic, two chunks of 3, from
             the ring with copy=False, the ring with copy=True and
             memory: bitwise-equal parameters and BN state for
             scan_steps=3, accumulate_steps=2 and per-call fits without
             prefetch. (d) `python -m deeplearning4j_tpu_torch.train
             --dataset mnist --synthetic-data --serve-port 0` on LeNet in
             a subprocess, beside (c): 8 predicts over the socket equal
             the reloaded output zip's output() on the card (atol 1e-5),
             then SIGTERM drains it and it exits 0. `launches_by_path` gains
             "data_plane": (b)'s profiled kernel events, n_layers x 16 of
             each kernel; (a), (c) and (d) launch none (the wrappers'
             counts).
12. telemetry — monitor/ on the card. (a) The full-width LM saved as a
             zip and trained by train.cli.main with `--metrics
             --trace-out --perf-ledger`, 80 seeded sequences of batch 4
             = 20 steps, per call and with DL4J_CUDA_SCAN_STEPS=10: every
             flash kernel launched, the ledger's one program
             (`mln/train_step`, `mln/scan_step` with K = 10) within 5 %
             of the analytic FLOPs a step (every matmul, 6 x 13.1 M
             weights x 8192 tokens, plus the kernels at 18·D a causal
             pair: 9.54e11), the HBM breakdown, `train_mfu_pct` within
             1 % of the program's FLOPs over a measured step over 989
             TFLOP/s (per call the trace's last `train/step`; with the
             graph the gauge of a replayed fit of the reloaded LM, the
             ledger on, against that same fit timed by CUDA events, the
             median of three such fits), goodput categories summing to the session's wall
             time, span counts, and the port's trace_report and
             tools/perf_report.py (stdlib only) reading the files with
             exit 0. (b) ResNet-50 bf16 at the bench shape through
             fit(scan_steps=10), epochs of 20 steps: 1-epoch fits with
             telemetry off and with tracing, the ledger and goodput on,
             TELE_RESNET_ROUNDS in turns: step ms medians and spreads,
             syncs a step equal off and on (sync_sites), host launch
             calls a step equal (launch_profile, one chunk), the ledger
             within 5 % of the FLOPs counted from the conv shapes
             (bench.py's 3.149e12 printed beside),
             `train_mfu_pct`; then f32 once. (c) `serving.cli.build` over
             the LM as `lm` (predict) and `gen` (4 slots, 16-token
             pages), first without telemetry (`--no-flight`), then with
             `--trace-out --postmortem-dir --enable-fault-injection
             --slo-p99-ms --slo-availability`: 64 predicts and 4 greedy
             streams of 64 tokens, `/metrics` scraped before and after
             (the request counters grow by exactly what was sent), each
             token the oracle's argmax, no program first run on the
             request path, a `traceparent` request found in
             `/v1/debug/flight`, `/v1/timeseries` and `/v1/slo`, then
             `POST /v1/faults` until the availability SLO fires: every
             5xx counted, `http_5xx` and `slo_availability_burn`
             postmortems written; tokens/s and ITL p50 on and off.
             `launches_by_path` gains "telemetry" ((a)'s wrapper
             counts: replays do not pass the wrapper).
13. resilience — fault-tolerant training on the card. (a) The
             full-width LM with residual dropout 0.1 (attention dropout
             0, so the flash kernels run) saved as a zip, 40 seeded
             sequences = 2 epochs of 10 steps at batch 4, through the
             train CLI with `--checkpoint-dir --save-every-iterations 5`:
             (i) uninterrupted; (ii) DL4J_CUDA_FAULTS=preempt_at=7
             exiting 3 with no output zip, then `--resume`; (iii) in a
             subprocess, a real SIGTERM once two checkpoints are on disk
             (exit 3), then `--resume` in another, both beside (i) and
             (ii) (the runs share nothing). (ii) and (iii) end
             with output zips and last checkpoints' resilience.json
             bitwise (i)'s; each run launches each flash kernel n_layers
             times a step it trained; checkpoint save and restore seconds
             by the phase's stopwatch against the
             `resilience_checkpoint_{save,restore}_seconds` histograms
             (within 5 %), zip bytes. (b) ResilientTrainer on the LM
             under DL4J_CUDA_FAULTS=transient_at=4;nan_at=6: one retry,
             one skip, the retried step bitwise the unfaulted run's, the
             skip leaving the parameters bitwise as before it; a run of
             NaN steps past max_consecutive_skips rolls back to the
             newest checkpoint, the model bitwise that zip. (c) ms a
             step (CUDA events) and syncs a step of the per-call fit, a
             guarded and an unguarded resilient step, in turns; the
             device snapshot's bytes and ms beside its bound, and its
             copies grouped by dtype against one mixed-dtype foreach.
             (d) An
             async CheckpointListener's zip bitwise a synchronous one's
             at the same iteration, syncs a step of each;
             EarlyStoppingTrainer with InMemoryModelSaver giving back the
             best epoch's parameters, not the last; a ProfilerListener
             window of 3 LM steps (after a warm-up step) whose trace
             names each flash kernel n_layers x 3 times. (e) memory_report of the LM (batch 4),
             ResNet-50 bf16 (batch 128, 224²) and LeNet (batch 16):
             analytic total against the measured peak, within the
             reference's 2x bound for LeNet (the case the reference
             holds to it; the others are reported), and the network
             bitwise unchanged. (f) LBFGS,
             CG and steepest descent on an f64 logistic regression, card
             against CPU within 1e-9 of each score, LBFGS in fewer
             iterations. `launches_by_path` gains "resilience" ((a)'s
             five CLI runs, the subprocesses' counts printed by them).

14. fleet   — the serving fleet on the card, the full-width LM saved
             once as v1.zip. (a) The CLI's fleet mode (`--replicas 2
             --replica-mode inprocess --buckets 1,4 --device cuda`): 25
             inputs of batch 1 and 25 of batch 4, each sent through the
             router and straight to one replica in turn (which goes
             first alternates), then a 4-way burst through the router;
             every answer within 1e-6 of v1 with plain attention, both
             replicas dispatching, `flash_fwd` launches = n_layers x the
             replicas' summed dispatches, no backward launch; latency
             per bucket and route and the router's added ms (paired
             differences: median, quartiles, range), the relay's parts
             timed inside the router (reading the request, the hop to
             the replica, writing the answer), the hedge count. (b)
             The port's chaos drill
             (`tools/serve_chaos`, its own process) on 3 subprocess
             replicas of v1 (`.npy` bodies, token ids): SIGKILL one and
             wedge another under closed-loop priority-tagged traffic;
             zero 5xx, both rejoin with their generation bumped within
             150 s, batch-class shedding, p99 recovered, the
             availability alert fired and resolved, the drill's router
             holding no card memory (nvidia-smi); then its
             disaggregation drill on v1 as an LM servable (roles
             prefill, decode; 382-token prompts, 96 KV pages of 4 tokens
             a transfer; the prefill replica SIGKILLed mid-transfer):
             every stream completes, and the streams whose transfer
             completed give a single server's 32 greedy tokens exactly.
             Launch-to-ready, kill-to-ready and wedge-to-ready seconds,
             p99s. (c) v2 = v1 after 2 fit steps on the card (each flash
             kernel n_layers x 2 times), saved and blessed with the
             port's CheckpointManager into the directory that a
             `--rollout-watch` fleet of 3 subprocess replicas tails:
             canary, then promote, zero 5xx under traffic, every
             replica's answer within 1e-6 of v2 with plain attention,
             v2's answers more than 10 x 1e-6 from v1's;
             then the port's rollout drill (`tools/rollout_drill`, its
             own classifier) on the card: the poisoned blessing rolled
             back with a `rollout_rejected` postmortem naming
             `probe_accuracy`, the autoscale ramp up and drained down
             with `forced_kills == 0`; `rollout_promote_s`,
             `rollout_rollback_detect_s`. `launches_by_path` gains
             "fleet": (a)'s forward launches and (c)'s two fit steps
             (the subprocess replicas are checked by their answers).
15. parallel — data-parallel training of the full-width LM (f32,
             AdamW 3e-4, seeded token batches). (a) train.cli.main's
             default `--mode sync` (a ParallelWrapper over the one-rank
             NCCL group the CLI forms) against `--mode single`, 10 steps
             each: parameters bitwise equal, equal flash launches
             (n_layers x 10 each), one all-reduce a step; then the plain
             and the plan's train step timed by CUDA events (p50), the
             plan's describe(). (b) Two processes on the one card over
             gloo (NCCL will not put two ranks on one GPU): which gloo
             collectives take CUDA tensors, the all-reduce ms of the
             LM's 54.6 MB f32 gradient (through host memory: not a
             multi-GPU number); SYNC at global batch 4 (2 a rank) for 4
             steps, the ranks bitwise equal to each other and within
             1e-5 of each leaf's update of a one-rank batch-4 run;
             AVERAGING (frequency 2, optimizer state averaged) with the
             ranks' parameters after each average bitwise a by-hand
             emulation's (two networks stepping their halves, averaged
             in f32). (c) `--mesh data=1,zero=1` and `--mesh
             data=1,zero=3` through the CLI: bitwise (a)'s parameters
             (nothing splits over one rank); the fraction of the LM's
             bytes ZeRO would shard at data=2. (d) SharedGradientsTrainer
             in two processes over SocketTransport, the LM at depth 1,
             gradients threshold-encoded on the card: replicas bitwise
             equal, compression ratio, sparsity, bytes sent a step.
             `launches_by_path` gains "parallel": (a)'s sync run, (c)'s
             two runs, (b)'s and (d)'s ranks (each rank's own counts).
16. sequence — sequence and pipeline parallelism of the full-width LM
             (f32, AdamW 3e-4, TF32 off) in one pair of gloo ranks on the
             card (the ring's K/V through pinned host memory). (a)
             `ring_flash_self_attention` at (4, 2048, 8, 64) over seq=2
             (1024 a rank), causal and masked non-causal (a rank's whole
             shard of one row masked): each rank's output within 1e-4 of
             the card's plain dense attention of the whole sequence,
             dQ/dK/dV within 1e-4 of each tensor's largest entry of that
             attention's autograd; flash launches a call (2 forward, 2 of
             each backward), ms a call, the rotation's ms, bytes and
             route. (b) ContextParallelTrainer at seq=2, 4 steps: the
             ranks bitwise equal, each leaf within 1e-5 of its update
             of a one-process fit of the same batches after one step
             (1e-4 after four, phase 15's drift bound), over the elements
             whose first gradient is at least 1e-6; step p50, launches a
             step and rank. (c) PipelineParallelTrainer at stage=2 (2
             blocks a stage, 4 microbatches, bubble 1/5), 4 steps, the
             same comparisons. At most 90 s. `launches_by_path` gains
             "sequence" ((a) and (b)) and "pipeline" ((c)), both ranks.
17. tensor — tensor- and expert-parallel compute, in phase 16's pair of
             ranks after its parts: the full-width LM at data=1,model=2
             under `TransformerLM.sharding_rules()` (each rank 4 of the 8
             heads, half the MLP and half the vocabulary's rows). (a)
             `ParallelInference(net, plan=)` on a (4, 2048) batch: each
             rank's answer within 1e-5 of the one-process predict on the
             card and bitwise the other rank's, n_layers flash_fwd
             launches a forward and rank; ms a predict. (b) fit(plan=),
             4 steps of batch 4: the ranks bitwise equal (the replicated
             leaves are computed on each), each leaf within 1e-5 of its
             one-process update after one step and 1e-4 after four (phase
             15's rule, phase 16's one-process fit), n_layers launches of
             each kernel a step and rank, the program ledger's FLOPs a
             rank equal to the analytic count of the local shapes; step
             p50, the model group's collectives a step and their ms, the
             parameter bytes and peak memory a rank against one process.
             (c) TransformerLMMoE at the same width, depth 2 (8 experts,
             4 a rank), 2 steps: the same comparisons. At most 60 s.
             `launches_by_path` gains "tensor" ((a) to (c), both ranks).
18. nlp   — the native host library and the embedding trainers. (a) The
             port's C++ library (native/src/*.cpp) built with g++ from the
             checkout (OpenMP, else serial: the build it got is printed);
             every entry point against its numpy twin on seeded inputs
             (gemm in all four transposes, transforms, reductions,
             im2col/col2im, the CSV parser, the tokenizer's counts and
             encode, the codec, the HogWild skip-gram at one thread
             against its plain version), test_native.py's tolerances, and
             native.CALLS. (b) Word2Vec skip-gram / negative sampling at
             the GoogleNews vectors' width (300, window 5, 5 negatives,
             batch 512) over a 71,290-type vocabulary (text8's at
             min_count=5) counted by the native pass from a seeded Zipf
             corpus: 5 warm-up and 200 timed batches on the card, ms a
             batch split into host sampling, the step's host queueing and
             the step's span between CUDA events (which holds the card's
             waits on the host), pairs a second, the tables' bytes and
             the allocator's peak; the tables after 50 batches within
             1e-5 (relative to the largest entry) of the same 50 batches
             on the CPU, 30 of those batches under torch.profiler for the
             card's busy time a batch and its idle share. (c) CBOW with
             hierarchical softmax, GloVe's AdaGrad step, ParagraphVectors'
             DBOW label step and infer_vector at the same width, a few
             batches each, each within 1e-5 of the CPU. (d) DeepWalk at
             its paper's width (128, window 10, walk length 40) through
             `fit_graph` on a seeded random graph of BlogCatalog's 10,312
             nodes and 333,983 edges: a walk from every vertex, tables of
             10,312 rows, the fit stopped after 20 batches, within 1e-5 of
             the CPU. At most 45 s. `launches_by_path`
             gains "nlp" (no flash kernel runs there).
19. interop — model import, estimators and the training dashboard at full
             width, at most 60 s. (a) The DL4J bridge: the zoo's VGG16
             (224², 1000 classes, Nesterovs; 138,357,544 parameters) takes
             2 fit steps of batch 16 on the card, is written by
             save_dl4j_model (coefficients.bin + updaterState.bin; zip
             bytes, write and read seconds printed) and restored onto the
             card by restore_multilayer_network: parameters and a predict
             bitwise the source network's, and the next 2 fit steps of
             both bitwise equal (the updater state carried; cuDNN's
             deterministic algorithms); the same zip's coefficients
             restored onto the CPU predict within 1e-4 relative. (b)
             Keras: VGG16's Sequential config JSON, written here (13
             Conv2D 3x3 same, 5 MaxPooling2D, Flatten, Dense 4096, 4096,
             1000 softmax), through import_keras_model_configuration onto
             the card, given (a)'s saved weights in order: its predict
             within 1e-5 relative of (a)'s. With h5py on the machine the
             same weights go into a Keras .h5 archive that ModelRegistry
             deploys and a ModelServer answers over HTTP against the same
             numbers; without it the .h5 source must raise ModelLoadError
             naming h5py ("h5py": true|false is printed). (c)
             DL4JClassifier(hidden=(512, 256)) on the fetchers' seeded
             synthetic MNIST (2,048 images as 784 features, 10 classes), 2
             epochs on the card: predict_proba within 1e-5 of the same
             network moved to the CPU, and a pickle round trip bitwise.
             (d) The dashboard on a full-width fit: train.cli.main with
             --ui-port 0 --score-every 1 --mode single, 4 steps of batch 4
             over the full-width LM zip (T = 2048, the flash kernels), in
             process; while it runs the overview page, the model page's
             JSON (train/data) and the system page are fetched over HTTP;
             4 update records, each with params, gradients and updates
             summaries for every leaf, the last record's params equal to
             the reference's _summarize (a numpy copy here) on the output
             zip's parameters (histogram counts exactly, norm and mean
             magnitude within 1e-6 relative), and its gradients and
             updates the last step's: the updater on those gradients from
             the state before the step gives those updates bitwise, they
             added to the parameters before the step give the output
             zip's bitwise, and their plain summaries equal the record's
             (the same limits); the listener's ms a capture beside the
             step's ms. `launches_by_path` gains "ui" (the
             flash launches of (d)) and "interop" ((a)-(c): none).
20. apps   — clustering and manifold learning at full size, at most 75 s,
             on the fetchers' seeded synthetic MNIST (70,000 images as 784
             features). (a) KMeansClustering(k=10), 10 Lloyd iterations
             (of the default 100) on the card and on the CPU: each of the
             card's assignments against the CPU's on the same centers,
             a differing row a tie within the f32 expansion's rounding
             scale (printed, with the 1e-5-relative flag), the centers
             bitwise when no tie flipped, inertia within 1e-5; seeding s,
             the device ms of an assignment, the host ms of an update.
             (b) BarnesHutTsne(theta=0, perplexity=30, tile_rows=1024,
             seeded Gaussian start) at 70,000 points, k = 90: the
             affinity s; one tile of 1,024 rows against the CPU
             (neighbour sets equal but for ties within 1e-5 relative, p
             within 1e-5); one gradient evaluation: 1,024 sampled rows of
             the repulsion and of the gradient (attraction over the edges
             that touch them) against an f64 evaluation on the CPU and Z
             against an f64 evaluation on the card, all within 1e-5, its
             peak memory under 10 % of one N^2 f32 matrix; then 25
             iterations (of 500) by ms an iteration, every KL sample
             finite. (c) theta=0.5 on the same points: the
             affinity on the card, then 10 host iterations through the
             native sp-tree (native.CALLS["bh_repulsion_f32"] == 10; no
             native library fails the phase); BH's Z at (b)'s Y within 2
             % of (b)'s exact Z; BH's host repulsion against the card's
             exact pass at 70,000 and 10,000 points (which is faster is
             printed, not checked). (d) Tsne() at 10,000 points, all 500
             iterations: 256 sampled rows of the conditional P (before
             symmetrisation) within 1e-5 of the CPU's, the symmetric P
             summing to 1, the first 3 gradients within 1e-5 of the CPU's,
             the nearest embedded neighbour's label shared by > 95 % of
             points, ms an iteration, peak memory. (e)
             NearestNeighborsServer over a seeded 71,290 x 300 table over
             HTTP: 3 /knnnew and 2 /knn at k = 10 equal to a brute force
             on the card (distances within 1e-5 relative), 256 /insert
             (one rebuild), then queries still exact; build s, rebuild s,
             query p50 ms; RandomProjectionLSH(16 bits, 4 tables)'s
             recall@10; a KDTree over (b)'s embedding, 200 queries equal to
             the brute force; RandomProjection 784 -> 64's distortion over
             1,000 pairs. (f) (b)'s embedding through UIServer.post_tsne
             and GET /tsne/coords/<sid>, equal. `launches_by_path` gains
             "apps" (no flash kernel runs there).
21. scripts — the user scripts (deeplearning4j_tpu_torch/{examples,
             tools}) on the card, at most 45 s. (a) tools.flash_smoke at
             its shapes and dtypes (the JAX smoke's: 8 forward cases up
             to 8192 tokens, masked f32, padded, block sizes 64 and 256;
             4 backward cases; the return_lse merge): each kernel's
             output or gradients against the plain version's on the
             same inputs, forward f32 atol 1e-4 / bf16 atol and rtol
             2e-2, backward f32 atol 1e-4 / bf16 3e-2, kernel and plain
             ms by CUDA events. (b) tools.make_shards over 256 seeded
             224² PNGs in 4 class directories (--shuffle-seed 0
             --verify), then tools.etl_smoke reading those shards: the
             two-worker ring bitwise the in-process reader, a 2-epoch fit
             on the card, the etl_* families. (c) tools.serve_smoke: 240
             HTTP predicts on a zoo LeNet through a swap and a rollback,
             zero failures, the first-run ledger, 504 and 429 — traced.
             (d) tools.trace_report merging phase 12's serve trace and
             (c)'s (one pid: two tracks after the remap) and filtering
             one of phase 12's trace ids. (e) examples 01, 03, 04, 13 and
             14 at tests/test_examples.py's reduced settings, each held
             to the JAX example's check there, its result and wall
             seconds printed; 14 trains through the ring of a one-rank
             group, so the three kernels run. `launches_by_path` gains
             "scripts" ((b)-(e)) and "flash_smoke" ((a), comparisons).

Each path's counts are set to 0 just before it is driven and read just
after. The run sets DL4J_CUDA_ZIP_STORED=1 for itself and every process
it starts: the zips the port writes (the CLIs' outputs, the listeners'
checkpoints) are stored, not deflated, which at tens of MB/s on the host
cost the run minutes. Every phase's row carries `t_s`, the seconds since
the run started. At each phase's start and end a ``{"host_reading":
...}`` line says what the process can read without changing the machine:
wall seconds since the start, its own and its children's CPU seconds
(`resource.getrusage`), the load average, the CPUs it may use
(`os.sched_getaffinity`), and the card's SM and memory clocks,
temperature and power draw (one `nvidia-smi --query-gpu` call): where a
slow run's time went, phase by phase. The second-to-last line is the kernel table
(``{"kernels": [...]}``); the last is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import io
import json
import logging
import math
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import warnings
import zipfile

import numpy as np

if __name__ == "__mp_main__":
    # a worker of the data plane's ring: multiprocessing's spawn runs the
    # parent's main file in each, which the workers never call, and
    # importing torch there delayed the ring's first batch by seconds
    torch = None
else:
    import torch

# the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W), by
# dtype name
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,        # CUDA cores, no tensor cores
              "bfloat16": 989e12}      # tensor cores


def peak_flops(dtype) -> float:
    """PEAK_FLOPS of a torch dtype or a dtype name."""
    return PEAK_FLOPS[str(dtype).rpartition(".")[2]]

LM_SOURCE = ("zoo:TransformerLM?vocab_size=1024&seq_length=2048&n_layers=4"
             "&n_embd=512&n_heads=8&mlp_ratio=4&attention_impl=flash")
N_LAYERS, SEQ, VOCAB, HEADS, HEAD_DIM = 4, 2048, 1024, 8, 64
# the zips a phase saves as its input are stored, not deflated: deflate
# runs at tens of MB/s on the host (a ResNet-50 zip takes seconds), and
# the checkpoint manager stores its zips too
STORED = zipfile.ZIP_STORED
FLASH_SOURCE = "deeplearning4j_tpu_torch/ops/csrc/flash_attention_fwd.cu"
FLASH_REPLACES = "deeplearning4j_tpu/ops/flash_attention.py:58"
BWD_SOURCE = "deeplearning4j_tpu_torch/ops/csrc/flash_attention_bwd.cu"
BWD_REPLACES = {"flash_bwd_dq": "deeplearning4j_tpu/ops/flash_attention.py:183",
                "flash_bwd_dkv": "deeplearning4j_tpu/ops/flash_attention.py:216"}
KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the train phase: 32 sequences, batch 4, 2 epochs = 16 steps
TRAIN_SEQS, TRAIN_BATCH, TRAIN_EPOCHS = 32, 4, 2
TRAIN_STEPS = TRAIN_SEQS // TRAIN_BATCH * TRAIN_EPOCHS
GRAD_REL_TOL = 1e-4     # kernels vs plain attention, per parameter leaf
# the generate phase: prompt lengths (1500 goes in chunks of the default
# 64-token budget and shares its first 1024 tokens with a later prompt)
GEN_LENGTHS = (17, 100, 700, 1500)
# the resnet phase: the reference bench's shape (bench.py:209, batch 128 at
# 224x224) and its FLOP count (bench.py:277: 2 x 4.1 GMAC x 3 a image)
RESNET_BATCH, RESNET_HW, RESNET_STEPS = 128, 224, 20
RESNET_WARMUP, RESNET_TIMED = 3, 10
# resnet_fit's timed fits a mode after its warm/capture fit (cut to one
# to keep the whole run inside its time limit)
RESNET_FIT_TIMED = 1
RESNET_FLOP_PER_IMAGE = 24.6e9
RESNET_PARITY = dict(num_classes=10, input_shape=(64, 64, 3))
RESNET_CLI_IMAGES, RESNET_CLI_BATCH = 64, 32


_T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's row carries `t_s`, the seconds since the
    run started (the timeline of where the run's time goes)."""
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - _T0, 1))
    print(json.dumps(obj), flush=True)


GPU_READING = "clocks.sm,clocks.mem,temperature.gpu,power.draw"


def host_reading(phase: str, at: str):
    """One ``{"host_reading": ...}`` line at a phase's start or end (the
    module docstring): reads only, nothing on the machine is set."""
    me = resource.getrusage(resource.RUSAGE_SELF)
    kids = resource.getrusage(resource.RUSAGE_CHILDREN)
    try:
        card = subprocess.run(
            ["nvidia-smi", f"--query-gpu={GPU_READING}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        card = f"unreadable: {type(e).__name__}"
    print(json.dumps({"host_reading": {
        "phase": phase, "at": at,
        "wall_s": round(time.perf_counter() - _T0, 3),
        "cpu_s": round(me.ru_utime + me.ru_stime, 3),
        "children_cpu_s": round(kids.ru_utime + kids.ru_stime, 3),
        "loadavg": [round(x, 2) for x in os.getloadavg()],
        "cpus": len(os.sched_getaffinity(0)),
        "card": dict(zip(GPU_READING.split(","),
                         (v.strip() for v in card.split(","))))
        if not card.startswith("unreadable") else card}}), flush=True)


def run_phase(name: str, fn, *args, tmp: bool = False):
    """Run one phase between two host readings; with `tmp`, in a fresh
    temporary directory passed as its last argument."""
    host_reading(name, "start")
    try:
        if tmp:
            with tempfile.TemporaryDirectory() as d:
                return fn(*args, d)
        return fn(*args)
    finally:
        host_reading(name, "end")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def ptxas_report(log: str):
    """Registers and spills of each kernel from nvcc's -Xptxas -v output:
    [{"kernel", "registers", "spill_stores", "spill_loads"}, ...]."""
    import re
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"(flash_(?:fwd|bwd)_[a-z0-9_]+?)I(.*?)Li(\d+)E", name)
            if k is not None:     # flash_bwd_dq<f32,D=64> from the mangling
                fn, targ, dim = k.groups()
                dtype = "bf16," if "bfloat16" in targ else \
                    "f32," if targ == "f" else ""
                name = f"{fn}<{dtype}D={dim}>"
            cur = {"kernel": name}
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return rows


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class ProfEvent:
    """One torch.profiler event: its name (demangled, as torch.profiler
    names it), device type and start and end in microseconds."""

    __slots__ = ("name", "device_type", "start_us", "end_us")

    def __init__(self, name, device_type, start_us, end_us):
        self.name, self.device_type = name, device_type
        self.start_us, self.end_us = start_us, end_us

    @property
    def us(self) -> float:
        return self.end_us - self.start_us


# the events torch.profiler's own event list leaves out
_UNLISTED_EVENTS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new",
    "profiler::_record_function_exit", "aten::is_leaf", "aten::output_nr",
    "aten::_version"))


def profiler_events(prof):
    """`prof`'s events as `prof.events()` lists them (but for its merge
    of a CPU op into a same-named only child), read from the profiler's
    raw results: `prof.events()` builds a tree of Python objects, seconds
    for a window of ResNet-50 steps."""
    names, out = {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in _UNLISTED_EVENTS \
                or getattr(e, "is_hidden_event", lambda: False)():
            continue
        if name not in names:
            names[name] = torch._C._demangle(name) if len(name) > 1 \
                else name
        start = e.start_ns() / 1e3
        out.append(ProfEvent(names[name], e.device_type(), start,
                             start + e.duration_ns() / 1e3))
    return out


def device_ms(fn, match=None, iters: int = 10, tries: int = 3):
    """Device time per call of the CUDA kernels `fn` launches (only those
    whose name holds `match`, if given: one per call), from torch.profiler's
    kernel events after a warm-up call: the kernels' own time, without the
    host work around their launches. A window whose event count is not a
    whole number of calls lost events and is taken again; None when no
    window of `tries` is whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = [e.us for e in profiler_events(prof)
              if e.device_type == DeviceType.CUDA
              and (match is None or match in e.name)]
        if us and (len(us) == iters if match else len(us) % iters == 0):
            return sum(us) / 1e3 / iters
    return None


def device_columns(kernel_dev_ms, library_dev_ms, bound_ms, flops_per_pair,
                   q, k):
    """The kernel_time row's profiler columns; "not measured" where the
    profiler saw no device time."""
    if kernel_dev_ms is None:
        return {"kernel_device_ms": "not measured",
                "library_device_ms": library_dev_ms or "not measured"}
    return {"kernel_device_ms": kernel_dev_ms,
            "library_device_ms": library_dev_ms or "not measured",
            "device_roofline_share": bound_ms / kernel_dev_ms,
            "device_tflops": tflops(flops_per_pair, q, k, True,
                                    kernel_dev_ms)}


def attention_bound_ms(q, k, causal):
    """Least time for the function on these (unmasked) inputs: the larger
    of its bytes (q, k, v read once; O and LSE written once) over the
    memory rate and its flops (4*D per (query, key) pair that causality
    keeps: Q.K and P.V) over the peak for the input type."""
    b, tq, h, d = q.shape
    flops = attention_flops(4, q, k, causal)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + b * h * tq * 4
    t_ops = flops / peak_flops(q.dtype)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def make_qkv(b, tq, tk, h, d, dtype, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda t: torch.randn(b, t, h, d, generator=g).to("cuda", dtype)
    return mk(tq), mk(tk), mk(tk)


def check_kernel_cases(fa):
    """Phase 3a: the kernel against the plain version on the card."""
    mask_full = torch.ones(2, 384, device="cuda")
    mask_full[0, 300:] = 0.0
    mask_full[1] = 0.0                              # all rows fully masked
    mask_lead = torch.ones(2, 384, device="cuda")
    mask_lead[0, :10] = 0.0                         # causal rows 0-9 dead
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("bench_bf16_causal", make_qkv(4, 2048, 2048, 8, 64, bf16, 1), None,
         True),
        ("main_path_f32_causal", make_qkv(4, 2048, 2048, 8, 64, f32, 2),
         None, True),
    ]
    # every edge case for both kernels (f32 CUDA cores, bf16 tensor cores)
    for dt, tag in ((f32, "f32"), (bf16, "bf16")):
        qkv = torch.randn(2, 256, 3, 4, 64, device="cuda").to(dt)
        cases += [
            (f"{tag}_mask_fully_masked_rows",
             make_qkv(2, 384, 384, 8, 64, dt, 3), mask_full, False),
            (f"{tag}_mask_causal_dead_leading_rows",
             make_qkv(2, 384, 384, 8, 64, dt, 4), mask_lead, True),
            (f"{tag}_ragged_t1000_causal",
             make_qkv(2, 1000, 1000, 4, 64, dt, 5), None, True),
            (f"{tag}_tq300_tk700", make_qkv(2, 300, 700, 4, 64, dt, 6), None,
             False),
            (f"{tag}_tq700_tk300_causal",
             make_qkv(2, 700, 300, 4, 64, dt, 7), None, True),
            (f"{tag}_d32_causal", make_qkv(2, 512, 512, 4, 32, dt, 8), None,
             True),
            (f"{tag}_d128_causal", make_qkv(2, 512, 512, 4, 128, dt, 9), None,
             True),
            (f"{tag}_d128_masked", make_qkv(2, 384, 384, 8, 128, dt, 10),
             mask_full, False),
            (f"{tag}_strided_qkv_views", tuple(qkv[:, :, i] for i in range(3)),
             None, True),
        ]
    errs = {}
    for name, (q, k, v), mask, causal in cases:
        out, lse = fa.flash_attention_cuda(q, k, v, mask, causal)
        torch.cuda.synchronize()
        ref, rlse = fa.flash_attention_plain(q, k, v, mask, causal)
        tol = dict(atol=1e-4, rtol=0.0) if q.dtype == torch.float32 \
            else dict(atol=2e-2, rtol=2e-2)
        err_o = (out.float() - ref.float()).abs().max().item()
        err_l = (lse - rlse).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), **tol) and \
            torch.allclose(lse, rlse, **tol) and \
            bool(torch.isfinite(out.float()).all())
        emit({"phase": "kernel_check", "case": name,
              "shape": [list(q.shape), list(k.shape)],
              "dtype": str(q.dtype).replace("torch.", ""), "causal": causal,
              "masked": mask is not None, "max_abs_err_o": err_o,
              "max_abs_err_lse": err_l, "ok": ok})
        if not ok:
            raise AssertionError(f"flash kernel disagrees with plain: {name}")
        errs[name] = err_o
    # the public wrapper: padding to the block, the LSE boundary mapping
    q, k, v = make_qkv(2, 1000, 1000, 4, 64, torch.float32, 11)
    out, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    ref, rlse = fa.flash_attention_plain(q, k, v, None, True)
    rlse = rlse.reshape(2, 4, 1000).transpose(1, 2)
    ok = torch.allclose(out, ref, atol=1e-4, rtol=0) and \
        torch.allclose(lse, rlse, atol=1e-4, rtol=0)
    emit({"phase": "kernel_check", "case": "public_wrapper_padded_lse",
          "ok": ok})
    if not ok:
        raise AssertionError("flash_attention wrapper disagrees with plain")
    return errs


def check_fwd_determinism(fa):
    """Phase 3a': two forward calls on the same inputs give bitwise-equal
    O and LSE (no atomics, a fixed order), in both routes at the main-path
    (f32) and bench (bf16) shapes and on a ragged, masked causal case."""
    mask = torch.ones(2, 1000, device="cuda")
    mask[0, 700:] = 0.0
    mask[1, :5] = 0.0                               # causal rows 0-4 dead
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("main_path_f32_causal", make_qkv(4, SEQ, SEQ, HEADS, HEAD_DIM,
                                               f32, 2), None),
             ("bench_bf16_causal", make_qkv(4, 2048, 2048, 8, 64, bf16, 1),
              None)]
    for dt, tag in ((f32, "f32"), (bf16, "bf16")):
        cases.append((f"{tag}_ragged_masked_causal",
                      make_qkv(2, 1000, 1000, 4, 64, dt, 15), mask))
    for name, (q, k, v), m in cases:
        first = fa.flash_attention_cuda(q, k, v, m, True)
        again = fa.flash_attention_cuda(q, k, v, m, True)
        torch.cuda.synchronize()
        same = {n: bool(torch.equal(a, b))
                for n, a, b in zip(("o", "lse"), first, again)}
        emit({"phase": "fwd_determinism", "case": name,
              "dtype": str(q.dtype).replace("torch.", ""),
              "bitwise_equal": same, "ok": all(same.values())})
        if not all(same.values()):
            raise AssertionError(f"two forward calls differ: {name} {same}")


def bwd_inputs(fa, q, k, v, mask, causal, seed, with_g_lse=False):
    """The backward's inputs from the forward kernel: (out, lse, g_out,
    g_lse). g_out is a non-contiguous view with a unit D stride, as
    autograd may hand over; g_lse is zero unless asked for."""
    out, lse = fa.flash_attention_cuda(q, k, v, mask, causal)
    b, tq, h, d = q.shape
    g = torch.Generator(device="cpu").manual_seed(seed)
    g_out = torch.randn(b, h, tq, d, generator=g).to("cuda", q.dtype) \
        .transpose(1, 2)
    g_lse = torch.randn(b * h, tq, generator=g).to("cuda") if with_g_lse \
        else torch.zeros(b * h, tq, device="cuda")
    return out, lse, g_out, g_lse


def check_bwd_cases(fa):
    """Phase 3c: the backward kernels against the plain backward on the
    card: dQ, dK and dV from the same forward outputs and cotangents."""
    mask_full = torch.ones(2, 384, device="cuda")
    mask_full[0, 300:] = 0.0
    mask_full[1] = 0.0                              # all rows fully masked
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("main_path_f32_causal", make_qkv(4, 2048, 2048, 8, 64, f32, 2),
         None, True, False),
        ("bench_bf16_causal", make_qkv(4, 2048, 2048, 8, 64, bf16, 1), None,
         True, False),
    ]
    for dt, tag in ((f32, "f32"), (bf16, "bf16")):
        qkv = torch.randn(2, 256, 3, 4, 64, device="cuda").to(dt)
        cases += [
            (f"{tag}_mask_fully_masked_rows",
             make_qkv(2, 384, 384, 8, 64, dt, 3), mask_full, False, False),
            (f"{tag}_mask_causal_g_lse",
             make_qkv(2, 384, 384, 8, 64, dt, 4), mask_full, True, True),
            (f"{tag}_ragged_t1000_causal",
             make_qkv(2, 1000, 1000, 4, 64, dt, 5), None, True, False),
        ]
        for tq, tk in ((300, 700), (700, 300)):
            for causal in (False, True):
                cases.append((f"{tag}_tq{tq}_tk{tk}_{'causal' if causal else 'full'}",
                              make_qkv(2, tq, tk, 4, 64, dt, 6), None, causal,
                              False))
        cases += [
            (f"{tag}_d32_causal", make_qkv(2, 512, 512, 4, 32, dt, 8), None,
             True, False),
            (f"{tag}_d128_causal", make_qkv(2, 512, 512, 4, 128, dt, 9), None,
             True, False),
            (f"{tag}_d128_masked", make_qkv(2, 384, 384, 8, 128, dt, 10),
             mask_full, False, True),
            (f"{tag}_strided_qkv_views", tuple(qkv[:, :, i] for i in range(3)),
             None, True, False),
        ]
    errs = {}
    for name, (q, k, v), mask, causal, with_g_lse in cases:
        out, lse, g_out, g_lse = bwd_inputs(fa, q, k, v, mask, causal, 13,
                                            with_g_lse)
        got = fa.flash_attention_bwd_cuda(q, k, v, mask, out, lse, g_out,
                                          g_lse, causal)
        torch.cuda.synchronize()
        ref = fa.flash_attention_bwd_plain(q, k, v, mask, out, lse, g_out,
                                           g_lse, causal)
        tol = dict(atol=1e-4, rtol=0.0) if q.dtype == torch.float32 \
            else dict(atol=3e-2, rtol=3e-2)
        err = {n: (a.float() - r.float()).abs().max().item()
               for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
        ok = all(torch.allclose(a.float(), r.float(), **tol)
                 and bool(torch.isfinite(a.float()).all())
                 for a, r in zip(got, ref))
        emit({"phase": "bwd_kernel_check", "case": name,
              "shape": [list(q.shape), list(k.shape)],
              "dtype": str(q.dtype).replace("torch.", ""), "causal": causal,
              "masked": mask is not None, "g_lse": with_g_lse,
              "max_abs_err": err, "ok": ok})
        if not ok:
            raise AssertionError(f"flash backward kernels disagree with "
                                 f"plain: {name}")
        errs[name] = err
    return errs


def check_bwd_determinism(fa):
    """Phase 3c': two backward calls on the same inputs give bitwise-equal
    dQ, dK and dV (no atomics, a fixed summation order), in both routes at
    the main-path (f32) and bench (bf16) shapes and on a ragged, masked
    case with an LSE cotangent."""
    mask = torch.ones(2, 1000, device="cuda")
    mask[0, 700:] = 0.0
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("main_path_f32_causal", make_qkv(4, SEQ, SEQ, HEADS, HEAD_DIM,
                                               f32, 2), None, True, False),
             ("bench_bf16_causal", make_qkv(4, 2048, 2048, 8, 64, bf16, 1),
              None, True, False)]
    for dt, tag in ((f32, "f32"), (bf16, "bf16")):
        cases.append((f"{tag}_ragged_masked_g_lse",
                      make_qkv(2, 1000, 1000, 4, 64, dt, 15), mask, True,
                      True))
    for name, (q, k, v), m, causal, with_g_lse in cases:
        out, lse, g_out, g_lse = bwd_inputs(fa, q, k, v, m, causal, 16,
                                            with_g_lse)
        first = fa.flash_attention_bwd_cuda(q, k, v, m, out, lse, g_out,
                                            g_lse, causal)
        again = fa.flash_attention_bwd_cuda(q, k, v, m, out, lse, g_out,
                                            g_lse, causal)
        torch.cuda.synchronize()
        same = {n: bool(torch.equal(a, b))
                for n, a, b in zip(("dq", "dk", "dv"), first, again)}
        emit({"phase": "bwd_determinism", "case": name,
              "dtype": str(q.dtype).replace("torch.", ""),
              "bitwise_equal": same, "ok": all(same.values())})
        if not all(same.values()):
            raise AssertionError(f"two backward calls differ: {name} {same}")


def time_attention(fa, b, t, h, d, dtype, gpu):
    """Phase 3b: kernel, plain and library times at one causal shape."""
    import torch.nn.functional as F
    q, k, v = make_qkv(b, t, t, h, d, dtype, 12)
    kernel = lambda: fa.flash_attention_cuda(q, k, v, None, True)
    kernel_ms = cuda_ms(kernel)
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, None, True),
                       iters=5, warmup=1)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True)
    library_ms = cuda_ms(library)
    bound_ms, bound_by = attention_bound_ms(q, k, True)
    row = {"phase": "kernel_time", "kernel": "flash_fwd",
           "shape": [b, t, h, d], "dtype": str(dtype).replace("torch.", ""),
           "causal": True, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "roofline_share": bound_ms / kernel_ms,
           "tflops": tflops(4, q, k, True, kernel_ms),
           **device_columns(device_ms(kernel, "flash_fwd"),
                            device_ms(library), bound_ms, 4, q, k),
           "gpu": gpu}
    emit(row)
    return row


def live_pairs(tq, tk, causal):
    """(query, key) pairs per head that causality keeps."""
    return sum(min(i + 1, tk) for i in range(tq)) if causal else tq * tk


def attention_flops(flops_per_pair_per_d, q, k, causal):
    """The function's flops on these (unmasked) inputs: flops_per_pair_per_d
    * D per live (query, key) pair of every (batch, head)."""
    b, tq, h, d = q.shape
    return flops_per_pair_per_d * d * live_pairs(tq, k.shape[1], causal) \
        * b * h


def tflops(flops_per_pair_per_d, q, k, causal, ms):
    """Achieved TFLOP/s: the flops the bounds count, over `ms`."""
    return attention_flops(flops_per_pair_per_d, q, k, causal) \
        / (ms * 1e-3) / 1e12


def bwd_bound_ms(q, k, flops_per_pair_per_d, n_outputs_q, n_outputs_k,
                 causal):
    """Least time for one backward kernel's work on these (unmasked)
    inputs: q, k, v and dO read once, LSE and delta read once, its
    outputs written once; flops per live pair over the peak for the
    type."""
    b, tq, h, d = q.shape
    flops = attention_flops(flops_per_pair_per_d, q, k, causal)
    es = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel()) * es + 2 * b * h * tq * 4 \
        + (n_outputs_q * q.numel() + n_outputs_k * k.numel()) * es
    t_ops = flops / peak_flops(q.dtype)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_backward(fa, b, t, h, d, dtype, gpu):
    """Phase 3d: each backward kernel, the plain backward (all three
    gradients at once) and SDPA's backward at one causal shape."""
    import torch.nn.functional as F
    q, k, v = make_qkv(b, t, t, h, d, dtype, 12)
    out, lse, g_out, g_lse = bwd_inputs(fa, q, k, v, None, True, 14)
    g_out = g_out.contiguous()
    delta = fa._delta(out, g_out, g_lse, torch.float32)
    dq = lambda: fa.flash_attention_bwd_dq_cuda(q, k, v, None, lse, delta,
                                                g_out, True)
    dkv = lambda: fa.flash_attention_bwd_dkv_cuda(q, k, v, None, lse, delta,
                                                  g_out, True)
    dq_ms, dkv_ms = cuda_ms(dq), cuda_ms(dkv)
    whole_ms = cuda_ms(lambda: fa.flash_attention_bwd_cuda(
        q, k, v, None, out, lse, g_out, g_lse, True))
    plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, None, out, lse, g_out, g_lse, True), iters=5, warmup=1)
    qt, kt, vt = (a.transpose(1, 2).detach().requires_grad_(True)
                  for a in (q, k, v))
    gt = g_out.transpose(1, 2)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
        torch.autograd.grad(o, (qt, kt, vt), gt)

    library_ms = cuda_ms(sdpa_fwd_bwd) - cuda_ms(sdpa_fwd)
    lib_fwd_bwd, lib_fwd = device_ms(sdpa_fwd_bwd), device_ms(sdpa_fwd)
    library_dev_ms = lib_fwd_bwd - lib_fwd if lib_fwd_bwd and lib_fwd \
        else None
    rows = {}
    for name, ms, fn, fpp, nq, nk in (
            ("flash_bwd_dq", dq_ms, dq, 6, 1, 0),
            ("flash_bwd_dkv", dkv_ms, dkv, 8, 0, 2)):
        bound_ms, bound_by = bwd_bound_ms(q, k, fpp, nq, nk, True)
        rows[name] = {"phase": "kernel_time", "kernel": name,
                      "shape": [b, t, h, d],
                      "dtype": str(dtype).replace("torch.", ""),
                      "causal": True, "kernel_ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "roofline_share": bound_ms / ms,
                      "tflops": tflops(fpp, q, k, True, ms),
                      **device_columns(device_ms(fn, name), library_dev_ms,
                                       bound_ms, fpp, q, k),
                      "backward_total_ms": whole_ms, "gpu": gpu}
        emit(rows[name])
    return rows


def post_npy(url, x):
    buf = io.BytesIO()
    np.save(buf, x, allow_pickle=False)
    req = urllib.request.Request(
        url, data=buf.getvalue(), method="POST",
        headers={"Content-Type": "application/octet-stream",
                 "Accept": "application/octet-stream"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as r:
        status, body = r.status, r.read()
    ms = (time.perf_counter() - t0) * 1e3
    return status, np.load(io.BytesIO(body), allow_pickle=False), ms


def check_answer(status, y, batch):
    if status != 200:
        raise AssertionError(f"predict answered {status}")
    if y.shape != (batch, SEQ, VOCAB):
        raise AssertionError(f"predict shape {y.shape}")
    if not np.isfinite(y).all():
        raise AssertionError("predict returned non-finite values")
    if not np.allclose(y.sum(-1), 1.0, atol=1e-4):
        raise AssertionError("softmax rows do not sum to 1")


def serve(fa):
    """Phase 4: the main path, counted from zero."""
    from deeplearning4j_tpu_torch.serving import cli
    args = cli.build_parser().parse_args(
        ["--model", f"lm={LM_SOURCE}", "--port", "0", "--buckets", "1,4",
         "--max-delay-ms", "5"])
    for name in KERNELS:
        fa.KERNEL_LAUNCHES[name] = 0
    t0 = time.perf_counter()
    registry, server = cli.build(args)
    build_s = time.perf_counter() - t0
    served = registry.get("lm")
    url = f"{server.url}/v1/models/lm/predict"
    rs = np.random.RandomState(1234)
    try:
        warm_launches = fa.KERNEL_LAUNCHES["flash_fwd"]
        warm_dispatches = served.batcher.dispatches
        lat, answers = {1: [], 4: []}, {}
        for i in range(12):                        # sequential, mixed batch
            batch = 4 if i % 2 else 1
            x = rs.randint(0, VOCAB, (batch, SEQ, 1)).astype("float32")
            status, y, ms = post_npy(url, x)
            check_answer(status, y, batch)
            lat[batch].append(ms)
            answers.setdefault(batch, (x, y))
        burst = [rs.randint(0, VOCAB, (1, SEQ, 1)).astype("float32")
                 for _ in range(4)]
        results = [None] * 4

        def one(j):
            results[j] = post_npy(url, burst[j])

        threads = [threading.Thread(target=one, args=(j,)) for j in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        for r in results:
            if r is None:
                raise AssertionError("a concurrent predict never returned")
            check_answer(r[0], r[1], 1)
        launches = fa.KERNEL_LAUNCHES["flash_fwd"]
        dispatches = served.batcher.dispatches
        if fa.KERNEL_LAUNCHES["flash_bwd_dq"] or \
                fa.KERNEL_LAUNCHES["flash_bwd_dkv"]:
            raise AssertionError("the predict path launched a backward "
                                 "kernel")
        if launches != N_LAYERS * dispatches:
            raise AssertionError(f"{launches} kernel launches for {dispatches}"
                                 f" dispatches of a {N_LAYERS}-layer network")
        if launches - warm_launches != N_LAYERS * (dispatches - warm_dispatches) \
                or dispatches == warm_dispatches:
            raise AssertionError("requests did not go through the kernel")
        # one answer against the same network with plain attention
        x4, y4 = answers[4]
        real = fa.flash_attention_cuda
        fa.flash_attention_cuda = \
            lambda q, k, v, mask, causal: fa.flash_attention_plain(
                q, k, v, mask, causal)
        try:
            ref = served.model.output(x4).float().cpu().numpy()
        finally:
            fa.flash_attention_cuda = real
        if fa.KERNEL_LAUNCHES["flash_fwd"] != launches:
            raise AssertionError("the plain reference launched the kernel")
        err = float(np.abs(y4 - ref).max())
        if not err <= 1e-4:
            raise AssertionError(f"served answer vs plain attention: {err}")
        # one forward per bucket on the device timeline (CUDA events around
        # output(): no HTTP, no copy back, but the host's launch gaps are
        # inside); the rest of a request's wall time is host work
        forward_ms = {str(b): cuda_ms(lambda b=b: served.model.output(
            answers[b][0]), iters=5, warmup=1) for b in (1, 4)}
        all_ms = lat[1] + lat[4]
        emit({"phase": "serve", "source": LM_SOURCE,
              "params": served.model.num_params(),
              "build_and_warm_s": build_s, "warmup_s": served.warmup_seconds,
              "requests": len(all_ms) + len(burst),
              "p50_ms": {str(b): statistics.median(v) for b, v in lat.items()},
              "max_ms": {str(b): max(v) for b, v in lat.items()},
              "p50_ms_all": statistics.median(all_ms), "max_ms_all": max(all_ms),
              "forward_span_ms": forward_ms,
              "dispatches": dispatches, "warmup_dispatches": warm_dispatches,
              "kernel_launches": launches,
              "launches_per_forward": launches / dispatches,
              "max_abs_err_vs_plain": err})
        return launches
    finally:
        server.drain(timeout=30)


def post_generate(url, name, payload, timeout=600):
    """One POST /v1/models/{name}/generate over the socket. SSE answers
    are read event by event, each token stamped on arrival. Returns
    {"status", "tokens", "times" (SSE only), "t0", "t_done", and the done
    event's or the JSON answer's fields}; a non-200 raises."""
    req = urllib.request.Request(
        f"{url}/v1/models/{name}/generate", data=json.dumps(payload).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        status = r.status
        if not payload.get("stream", True):
            doc = json.loads(r.read())
            return dict(doc, status=status, t0=t0,
                        t_done=time.perf_counter())
        toks, times, done = [], [], None
        for line in r:
            if not line.startswith(b"data: "):
                continue
            ev = json.loads(line[6:])
            if "token" in ev:
                toks.append(ev["token"])
                times.append(time.perf_counter())
            elif ev.get("done"):
                done = ev
            else:
                raise AssertionError(f"{name}: stream failed: {ev}")
        if done is None:
            raise AssertionError(f"{name}: stream ended without done")
        return dict(done, status=status, tokens=toks, times=times, t0=t0,
                    t_done=time.perf_counter())


def check_generation(res, payload, name):
    if res["status"] != 200 or not res["tokens"]:
        raise AssertionError(f"{name}: status {res['status']}, "
                             f"{len(res['tokens'])} tokens")
    if res["finish_reason"] != "length" or \
            len(res["tokens"]) != payload["max_tokens"]:
        raise AssertionError(f"{name}: finished {res['finish_reason']} "
                             f"after {len(res['tokens'])} tokens")
    if not all(0 <= t < VOCAB for t in res["tokens"]):
        raise AssertionError(f"{name}: token out of the vocabulary")


def oracle_check(net, prompt, tokens, top=1):
    """The served network's own output() on prompt + tokens, padded to
    the context (causal: the padding changes no position below the
    length): every token must be the argmax (top=1) or within the top
    `top` at its position. A miss where the oracle's deciding margin in
    log-probability is under 1e-4 is a near-tie, counted, not failed.
    Returns (positions checked, near-ties)."""
    seq = list(prompt) + list(tokens)
    x = np.zeros((1, SEQ, 1), np.float32)
    x[0, :len(seq) - 1, 0] = seq[:-1]
    logp = torch.log(net.output(x)[0].double().clamp_min(1e-300)).cpu() \
        .numpy()
    near = 0
    for i, tok in enumerate(tokens):
        row = logp[len(prompt) - 1 + i]
        order = np.argsort(-row)
        if tok in order[:top]:
            continue
        if row[order[top - 1]] - row[tok] < 1e-4:
            near += 1
            continue
        raise AssertionError(
            f"token {i} ({tok}) not in the oracle's top {top} "
            f"{order[:top].tolist()} (margin "
            f"{row[order[top - 1]] - row[tok]:.3g})")
    return len(tokens), near


def sample_check(engine):
    """The engine's sampler on the card: 16384 rows of one logits vector
    at T = 0.8, top-k 8; frequencies within total-variation 0.02 of
    softmax(logits / T) over the top 8, every draw inside the top 8."""
    n, temp, k = 16384, 0.8, 8
    g = torch.Generator(device="cpu").manual_seed(77)
    logits = torch.randn(VOCAB, generator=g, dtype=torch.float64) * 2
    lg = logits.float().to(engine.device).expand(n, VOCAB).contiguous()
    draws = engine._sample(lg, torch.full((n,), temp, device=engine.device),
                           torch.full((n,), k, dtype=torch.int64,
                                      device=engine.device), 1).cpu()
    top = torch.topk(logits, k).indices
    want = torch.zeros(VOCAB, dtype=torch.float64)
    want[top] = torch.softmax(logits[top] / temp, 0)
    freq = torch.bincount(draws, minlength=VOCAB).double() / n
    tv = 0.5 * (freq - want).abs().sum().item()
    inside = bool(torch.isin(draws, top).all())
    if not (tv < 0.02 and inside):
        raise AssertionError(f"sampler on the card: TV {tv}, inside {inside}")
    return {"rows": n, "temperature": temp, "top_k": k, "tv": tv,
            "all_in_top_k": inside}


def profile_decode_steps(engine, steps=4):
    """torch.profiler over `steps` decode steps: CUDA kernel launches and
    copies per step, device busy ms, the device's idle share of the host's
    wall time, and the host's time by operator (self time, per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in profiler_events(prof)
              if e.device_type == DeviceType.CUDA]
    if not events:
        return {"device_time": "not measured", "wall_ms": wall_ms}
    copies = [e for e in events if "memcpy" in e.name.lower()
              or "memset" in e.name.lower()]
    busy_ms = sum(e.us for e in events) / 1e3
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0) + e.us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_launches_per_step": (len(events) - len(copies)) / steps,
            "copies_per_step": len(copies) / steps,
            "top_kernels_ms": [[n[:80], v / 1e3] for n, v in top],
            "top_host_ops_ms_per_step": [
                [a.key[:60], a.self_cpu_time_total / 1e3 / steps,
                 a.count / steps] for a in host[:10]]}


def count_syncs(fn) -> int:
    """Host-device synchronisations `fn` makes, as CUDA's sync debug mode
    reports them."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def time_decode_steps(engine, rs):
    """engine.step() with all four slots live (prompts 17, 100, 700,
    1500 prefilled directly on the idle engine): per-step ms by CUDA
    events (the step's host work and its one copy back included) and by
    the host's clock, then a profiled window. A greedy and a sampling
    step may each synchronise at most once: the sampled tokens' copy
    back."""
    slots = []
    try:
        for n in GEN_LENGTHS:
            slot = engine.cache.admit(n)
            slots.append(slot)
            engine.prefill(slot, rs.randint(0, VOCAB, n), 0.0, 0)
        for _ in range(3):
            engine.step()
        torch.cuda.synchronize()
        dev_ms, host_ms = [], []
        replays0 = engine.graph_stats["replays"]
        for _ in range(32):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            engine.step()
            end.record()
            end.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
        replays = (engine.graph_stats["replays"] - replays0) / 32
        prof = profile_decode_steps(engine)
        syncs = {"greedy": count_syncs(engine.step)}
        engine._temps[slots[0]], engine._topks[slots[0]] = 1.0, 5
        syncs["sampling"] = count_syncs(engine.step)
    finally:
        for slot in slots:
            engine.release_slot(slot)
    if any(n > 1 for n in syncs.values()):
        raise AssertionError(f"syncs per decode step: {syncs} (at most 1)")
    if replays != 1:
        raise AssertionError(f"{replays} graph replays a decode step")
    return {"active_slots": len(slots), "step_ms_p50":
            statistics.median(dev_ms), "step_ms_max": max(dev_ms),
            "step_host_ms_p50": statistics.median(host_ms),
            "graph_replays_per_step": replays,
            "step_syncs": syncs, "step_profile": prof}


def graph_report(engines) -> dict:
    """Each engine's captured decode programs: how many, their memory
    pool's bytes, and the capture seconds inside its warm-up."""
    out = {}
    for name, e in engines.items():
        g = e.describe_graphs()
        out[name] = {"programs": len(g["programs"]),
                     "pool_bytes": g["pool_bytes"],
                     "capture_s": g["capture_s"]}
        if e.draft is not None:
            dg = e.draft.describe_graphs()
            out[name].update(draft_programs=len(dg["programs"]),
                             draft_pool_bytes=dg["pool_bytes"],
                             draft_capture_s=dg["capture_s"])
    return out


def generate(fa):
    """Phase 4b: the port's generation path, counted from zero:
    serving.cli.build with three LM servables (the full-width LM, its
    @int8 and @bf16 variants; 4 slots, 16-token pages), then 12 POST
    /v1/models/{name}/generate over the socket, SSE and JSON mixed."""
    from deeplearning4j_tpu_torch.serving import cli
    from deeplearning4j_tpu_torch.serving.quantize import quality_delta
    args = cli.build_parser().parse_args(
        ["--lm", f"gen={LM_SOURCE}", "--lm", f"gen8={LM_SOURCE}@int8",
         "--lm", f"gen16={LM_SOURCE}@bf16", "--decode-slots", "4",
         "--decode-page-size", "16", "--port", "0"])
    for name in KERNELS:
        fa.KERNEL_LAUNCHES[name] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    registry, server = cli.build(args)
    build_s = time.perf_counter() - t0
    lms = {n: registry.get(n) for n in ("gen", "gen8", "gen16")}
    engines = {n: lm.scheduler.admitting_engine() for n, lm in lms.items()}
    rs = np.random.RandomState(4321)
    prefix = rs.randint(0, VOCAB, 1024).tolist()
    prompts = {n: rs.randint(0, VOCAB, n).tolist() for n in GEN_LENGTHS}
    prompts[1500] = prefix + prompts[1500][1024:]
    hit = prefix + rs.randint(0, VOCAB, 100).tolist()
    greedy, results = [], []

    def run(name, prompt, max_tokens, stream, tag="alone", **kw):
        payload = dict(prompt=prompt, max_tokens=max_tokens, stream=stream,
                       **kw)
        res = post_generate(server.url, name, payload)
        check_generation(res, payload, name)
        res.update(prompt_len=len(prompt), name=name, tag=tag)
        results.append(res)
        if name == "gen" and not kw:
            greedy.append((prompt, res["tokens"]))
        return res

    try:
        # one at a time on an idle server: TTFT by prompt length; the
        # 1500-token prompt goes in budgeted chunks and leaves its first
        # 1024 tokens in the prefix cache for the next request
        for n, stream in zip(GEN_LENGTHS, (False, True, False, True)):
            res = run("gen", prompts[n], 24, stream)
        if res["prefill_chunks"] < 2 or res["cached_tokens"] != 0:
            raise AssertionError(f"1500-token prompt: {res['prefill_chunks']}"
                                 f" chunks, {res['cached_tokens']} cached")
        res = run("gen", hit, 16, False)
        hit_cached = res["cached_tokens"]
        if hit_cached < 1024:
            raise AssertionError(f"shared 1024-token prefix: only "
                                 f"{hit_cached} tokens came from the cache")
        variant = {n: run(n, prompts[100], 16, n == "gen16")["tokens"]
                   for n in ("gen8", "gen16")}
        # four concurrent streams, then a late joiner once the first has
        # its first token: it must stream before the first one is done
        conc = [("gen", prompts[17], 160, True, {}),
                ("gen", prompts[100], 48, False, {}),
                ("gen", prompts[700], 32, True,
                 {"temperature": 1.0, "top_k": 5}),
                ("gen", prompts[17][:9] + prompts[100][:40], 48, True, {})]
        out = [None] * 5
        errors = []

        def one(j, spec):
            try:
                out[j] = run(*spec[:4], tag="concurrent", **spec[4])
            except Exception as e:      # noqa: BLE001 — re-raised below
                errors.append(e)

        t_conc = time.perf_counter()
        threads = [threading.Thread(target=one, args=(j, s))
                   for j, s in enumerate(conc)]
        for th in threads:
            th.start()
        # the first stream has its first token once decode steps run
        steps0, deadline = engines["gen"].steps, time.monotonic() + 300
        while engines["gen"].steps < steps0 + 2 and \
                time.monotonic() < deadline:
            time.sleep(0.001)
        late = threading.Thread(target=one, args=(
            4, ("gen", prompts[700][:300], 16, True, {})))
        late.start()
        for th in threads + [late]:
            th.join(timeout=600)
        if errors or any(o is None for o in out):
            raise AssertionError(f"concurrent streams failed: {errors}")
        conc_wall = max(o["t_done"] for o in out[:4]) - t_conc
        conc_tokens = sum(len(o["tokens"]) for o in out[:4])
        late_first, first_done = out[4]["times"][0], out[0]["t_done"]
        if not late_first < first_done:
            raise AssertionError("the late joiner's first token waited for "
                                 "the first stream to finish")
        launches = dict(fa.KERNEL_LAUNCHES)
        if any(launches.values()):
            raise AssertionError(f"the generate path launched flash kernels:"
                                 f" {launches}")
        first_runs = {n: e.request_path_first_runs
                      for n, e in engines.items()}
        if any(first_runs.values()):
            raise AssertionError(f"programs first ran on the request path: "
                                 f"{first_runs}")
        # the oracle: the served network's own output(), which runs the
        # flash forward kernel (its launches are counted apart)
        net = lms["gen"].model
        checked = near = 0
        for prompt, toks in greedy:
            c, t = oracle_check(net, prompt, toks)
            checked, near = checked + c, near + t
        c, t = oracle_check(net, conc[2][1], out[2]["tokens"], top=5)
        oracle_launches = fa.KERNEL_LAUNCHES["flash_fwd"]
        if oracle_launches != N_LAYERS * (len(greedy) + 1):
            raise AssertionError(f"oracle: {oracle_launches} flash launches")
        sampled = sample_check(engines["gen"])
        toks = rs.randint(0, VOCAB, (2, 256))
        quality = {n: quality_delta(engines["gen"], engines[n], toks)
                   for n in ("gen8", "gen16")}
        step = time_decode_steps(engines["gen"], rs)
        streams = [o for o in results if "times" in o and len(o["times"]) > 1]
        itl = [1e3 * (b - a) for o in streams
               for a, b in zip(o["times"], o["times"][1:])]
        ttft = {(str(o["prompt_len"]) if o["name"] == "gen"
                 else f"{o['name']}:{o['prompt_len']}"): o["ttft_ms"]
                for o in results if o["tag"] == "alone"}
        row = {"phase": "generate", "source": LM_SOURCE, "slots": 4,
               "page_size": 16, "build_and_warm_s": build_s,
               "warmup_s": {n: lm.warmup_seconds for n, lm in lms.items()},
               "graphs": graph_report(engines),
               "requests": len(results),
               "all_200": all(o["status"] == 200 for o in results),
               "tokens": sum(len(o["tokens"]) for o in results),
               "ttft_ms_by_prompt_len": ttft,
               "ttft_ms_concurrent": {str(o["prompt_len"]): o["ttft_ms"]
                                      for o in out},
               "itl_ms_p50": statistics.median(itl), "itl_ms_max": max(itl),
               "tokens_per_s_4_streams": conc_tokens / conc_wall,
               "prefix_hit_cached_tokens": hit_cached,
               "chunked_prefill_chunks": [o["prefill_chunks"] for o in results
                                          if o["prompt_len"] == 1500],
               "late_join_first_token_before_first_done": True,
               "late_join_margin_ms": (first_done - late_first) * 1e3,
               "oracle_greedy_tokens": checked, "oracle_near_ties": near,
               "oracle_topk_tokens": c, "oracle_topk_near_ties": t,
               "oracle_flash_launches": oracle_launches,
               "request_path_flash_launches": launches,
               "request_path_first_runs": first_runs,
               "variant_tokens": {n: len(v) for n, v in variant.items()},
               "quality_delta": quality, "sampler": sampled, **step,
               "engine_steps": engines["gen"].steps,
               "peak_memory_bytes": torch.cuda.max_memory_allocated()}
        emit(row)
        return row
    finally:
        server.drain(timeout=30)


def write_tokens(path, rs):
    """A learnable token set: each row is an arithmetic sequence mod VOCAB
    (seeded start and stride); labels are the next token, one-hot uint8."""
    start = rs.randint(0, VOCAB, (TRAIN_SEQS, 1))
    stride = rs.randint(1, 8, (TRAIN_SEQS, 1))
    seq = (start + stride * np.arange(SEQ + 1)) % VOCAB
    features = seq[:, :SEQ, None].astype("float32")
    labels = np.zeros((TRAIN_SEQS, SEQ, VOCAB), np.uint8)
    np.put_along_axis(labels, seq[:, 1:, None], 1, axis=-1)
    np.savez(path, features=features, labels=labels)
    return features, labels


class _ScoreLog(logging.Handler):
    """Collects the scores ScoreIterationListener logs."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.scores = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("Score at iteration"):
            self.scores.append(float(msg.rsplit(" ", 1)[1]))


def grads_vs_plain(fa, net, ds):
    """One batch's gradients through the kernels against the same with
    the plain attention versions swapped in: the largest per-leaf error
    relative to that leaf's largest plain gradient."""
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    _, g_kernel, _ = net.compute_gradient_and_score(ds)
    real = (fa.flash_attention_cuda, fa.flash_attention_bwd_cuda)
    fa.flash_attention_cuda = \
        lambda q, k, v, mask, causal: fa.flash_attention_plain(
            q, k, v, mask, causal)
    fa.flash_attention_bwd_cuda = fa.flash_attention_bwd_plain
    try:
        counts = dict(fa.KERNEL_LAUNCHES)
        _, g_plain, _ = net.compute_gradient_and_score(ds)
        if dict(fa.KERNEL_LAUNCHES) != counts:
            raise AssertionError("the plain reference launched a kernel")
    finally:
        fa.flash_attention_cuda, fa.flash_attention_bwd_cuda = real
    worst = 0.0
    for a, r in zip(tree_leaves(g_kernel), tree_leaves(g_plain)):
        scale = r.abs().max().item()
        worst = max(worst, (a - r).abs().max().item() / max(scale, 1e-30))
    return worst


def _category(name: str) -> str:
    for k in KERNELS:
        if k in name:
            return k
    if "gemm" in name.lower() or "sm90_xmma" in name or "cutlass" in name:
        return "matmul"
    return "other"


def profile_steps(net, batch, gen, steps=2):
    """Device time of `steps` train steps by kernel category, from
    torch.profiler's CUDA kernel events, and the device's idle share of
    the host's wall time over the same window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            float(net._train_step(batch, gen))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in profiler_events(prof)
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"phase": "train_profile", "device_time": "not measured",
                "wall_ms": wall_ms}
    by_cat, by_name = {}, {}
    for e in kernels:
        us = e.us
        by_cat[_category(e.name)] = by_cat.get(_category(e.name), 0) + us
        by_name[e.name] = by_name.get(e.name, 0) + us
    busy_ms = sum(by_cat.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"phase": "train_profile", "steps": steps, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "kernel_launches": len(kernels),
            "by_category_ms": {k: v / 1e3 for k, v in sorted(by_cat.items())},
            "top_kernels_ms": [[n[:80], v / 1e3] for n, v in top]}


def train(fa, tmp):
    """Phase 5: the training path, counted from zero: the full-width LM
    saved as a zip, trained by train.cli.main for TRAIN_STEPS steps on a
    seeded token set, its output zip reloaded and checked."""
    import contextlib
    import os
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.registry import parse_zoo_source
    from deeplearning4j_tpu_torch.train import cli as train_cli
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    name, kw = parse_zoo_source(LM_SOURCE[len("zoo:"):])
    lm_zip, out_zip = os.path.join(tmp, "lm.zip"), os.path.join(tmp, "out.zip")
    tokens = os.path.join(tmp, "tokens.npz")
    save_model(model_by_name(name, **kw).init(), lm_zip, compression=STORED)
    features, labels = write_tokens(tokens, np.random.RandomState(2024))
    log = logging.getLogger("deeplearning4j_tpu_torch")
    handler, level = _ScoreLog(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    stdout = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout):
            code = train_cli.main([
                "--model", lm_zip, "--output", out_zip, "--dataset", tokens,
                "--mode", "single", "--batch-size", str(TRAIN_BATCH),
                "--epochs", str(TRAIN_EPOCHS), "--score-every", "1"])
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    wall_s = time.perf_counter() - t0
    launches = dict(fa.KERNEL_LAUNCHES)
    lines = stdout.getvalue().strip().splitlines()
    result = json.loads(lines[-1])
    if code != 0 or set(result) != {"output", "final_score", "iterations",
                                     "epochs"}:
        raise AssertionError(f"train CLI: exit {code}, last line {lines[-1]}")
    if result["iterations"] != TRAIN_STEPS or \
            result["epochs"] != TRAIN_EPOCHS:
        raise AssertionError(f"train CLI ran {result}")
    scores = handler.scores
    if len(scores) != TRAIN_STEPS or not all(np.isfinite(scores)) or \
            not scores[-1] < scores[0]:
        raise AssertionError(f"training scores {scores}")
    if result["final_score"] != scores[-1]:
        raise AssertionError("score() is not the last training score")
    want = N_LAYERS * TRAIN_STEPS
    if any(launches[k] != want for k in KERNELS):
        raise AssertionError(f"launches {launches} != {want} per kernel")
    net = load_model(out_zip)
    if net.iteration_count != TRAIN_STEPS or net.opt_state is None or \
            int(net.opt_state["1"]["0"]["count"]) != TRAIN_STEPS:
        raise AssertionError("the output zip lost its counters or "
                             "updaterState.bin")
    ds = DataSet(features[:TRAIN_BATCH], labels[:TRAIN_BATCH])
    grad_err = grads_vs_plain(fa, net, ds)
    if not grad_err <= GRAD_REL_TOL:
        raise AssertionError(f"gradients with kernels vs plain: {grad_err}")
    # step times on the device timeline: the same step on the same
    # batch shape, CUDA events around each step's launches
    gen = torch.Generator(device="cuda").manual_seed(0)
    net._train_step(ds, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for i in range(6):
        batch = DataSet(features[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                        labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = net._train_step(batch, gen)
        end.record()
        float(loss)
        step_ms.append(start.elapsed_time(end))
    emit(profile_steps(net, batch, gen))
    row = {"phase": "train", "source": LM_SOURCE,
           "params": net.num_params(), "steps": TRAIN_STEPS,
           "batch": TRAIN_BATCH, "seq": SEQ, "cli_wall_s": wall_s,
           "first_score": scores[0], "last_score": scores[-1],
           "scores": scores, "launches": launches,
           "launches_per_step": {k: launches[k] / TRAIN_STEPS
                                 for k in KERNELS},
           "grad_rel_err_vs_plain": grad_err,
           "step_ms_p50": statistics.median(step_ms),
           "step_ms_max": max(step_ms), "step_ms": step_ms,
           "tokens_per_s": TRAIN_BATCH * SEQ / (statistics.median(step_ms)
                                                / 1e3),
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    return row


def _leaf_errors(a_tree, b_tree, before=None):
    """Largest |a - b| over the leaves of two trees (b on the CPU); with
    `before` (b's leaves before a step), each leaf's error over that leaf's
    largest update, the worst of them."""
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    b_leaves = dict(iter_leaves(b_tree))
    worst = 0.0
    for path, a in iter_leaves(a_tree):
        b = b_leaves[path]
        err = (a.detach().cpu() - b).abs().max().item()
        if before is not None:
            err /= max((b - before[path]).abs().max().item(), 1e-300)
        if err != err:                  # a NaN is the worst error
            return err
        worst = max(worst, err)
    return worst


def resnet_parity(tmp):
    """Phase 6a: ResNet50 (64x64, 10 classes) from one zip on the card and
    on the CPU, batch 4: output(), then one fit step, in f32 and f64."""
    import dataclasses
    import os
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    rs = np.random.RandomState(7)
    hw = RESNET_PARITY["input_shape"][0]
    X = rs.rand(4, hw, hw, 3)
    Y = np.eye(10)[rs.randint(0, 10, 4)]
    rows = {}
    for dtype in ("float32", "float64"):
        conf = dataclasses.replace(ResNet50(**RESNET_PARITY).conf(),
                                   dtype=dtype)
        src = ComputationGraph(conf, device="cpu").init()
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():                   # BN state off its init
            for _, t in iter_leaves(src.state):
                t.add_(0.2 * torch.rand(t.shape, generator=g))
        path = save_model(src, os.path.join(tmp, f"resnet_{dtype}.zip"),
                          save_updater=False, compression=STORED)
        gpu, cpu = load_model(path), load_model(path, device="cpu")
        x, y = X.astype(dtype), Y.astype(dtype)
        out = gpu.output(x)
        out_err = (out.cpu() - cpu.output(x)).abs().max().item()
        before = dict((p, t.clone()) for p, t in iter_leaves(cpu.params))
        mds = MultiDataSet((x,), (y,))
        gpu.fit(mds)
        cpu.fit(mds)
        rows[dtype] = {
            "output_max_abs_err": out_err,
            "output_finite": bool(torch.isfinite(out).all()),
            "score_card": gpu.score(), "score_cpu": cpu.score(),
            "score_rel_err": abs(gpu.score() - cpu.score())
            / abs(cpu.score()),
            "params_err_over_update": _leaf_errors(gpu.params, cpu.params,
                                                   before),
            "bn_state_max_abs_err": _leaf_errors(gpu.state, cpu.state)}
    f32, f64 = rows["float32"], rows["float64"]
    ok = (f32["output_finite"] and f32["output_max_abs_err"] <= 1e-4
          and f32["score_rel_err"] <= 1e-4
          and f64["output_max_abs_err"] <= 1e-10
          and f64["score_rel_err"] <= 1e-10
          and f64["params_err_over_update"] <= 1e-4
          and f64["bn_state_max_abs_err"] <= 1e-8)
    row = {"phase": "resnet_parity", "model": RESNET_PARITY, "batch": 4,
           "cudnn_benchmark": torch.backends.cudnn.benchmark,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "by_dtype": rows, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError(f"ResNet50 on the card vs the CPU: {rows}")
    return row


def resnet_cli(tmp):
    """Phase 6b: the entry point: the zoo's full ResNet50 saved with
    save_model, trained 2 steps by train.cli.main from an npz."""
    import contextlib
    import os
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.train import cli as train_cli
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    src, out = os.path.join(tmp, "resnet50.zip"), os.path.join(tmp, "o.zip")
    data = os.path.join(tmp, "images.npz")
    t0 = time.perf_counter()
    net = ResNet50().init()
    n_params = net.num_params()
    save_model(net, src, compression=STORED)
    del net
    rs = np.random.RandomState(11)
    labels = np.zeros((RESNET_CLI_IMAGES, 1000), np.uint8)
    labels[np.arange(RESNET_CLI_IMAGES),
           rs.randint(0, 1000, RESNET_CLI_IMAGES)] = 1
    np.savez(data, features=rs.rand(RESNET_CLI_IMAGES, RESNET_HW, RESNET_HW,
                                    3).astype("float32"), labels=labels)
    setup_s = time.perf_counter() - t0
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        code = train_cli.main(["--model", src, "--output", out, "--dataset",
                               data, "--mode", "single", "--batch-size",
                               str(RESNET_CLI_BATCH), "--score-every", "1"])
    wall_s = time.perf_counter() - t0
    last = stdout.getvalue().strip().splitlines()[-1]
    result = json.loads(last)
    steps = RESNET_CLI_IMAGES // RESNET_CLI_BATCH
    trained = load_model(out)
    ok = (code == 0 and result["iterations"] == steps
          and result["epochs"] == 1 and np.isfinite(result["final_score"])
          and isinstance(trained, ComputationGraph)
          and trained.iteration_count == steps
          and trained.opt_state is not None
          and trained.num_params() == n_params)
    row = {"phase": "resnet_cli", "params": n_params,
           "images": RESNET_CLI_IMAGES, "batch": RESNET_CLI_BATCH,
           "setup_s": setup_s, "cli_wall_s": wall_s, "result": result,
           "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError(f"train CLI on ResNet50: exit {code}, {last}")
    return row


def _resnet_category(name: str, phase: str) -> str:
    low = name.lower()
    if phase == "optimizer":
        return "optimizer"
    if "batch_norm" in low or "batchnorm" in low or "bn_fw" in low \
            or "bn_bw" in low:
        return "batch_norm"
    if any(t in low for t in ("conv", "xmma", "gemm", "cutlass", "implicit",
                              "winograd", "dgrad", "wgrad", "fprop")):
        return "convolution_" + phase
    if "elementwise" in low or "vectorized" in low or "unrolled" in low:
        return "elementwise"
    return "other"


def resnet_phased_profile(net, mds, gen, steps=2):
    """Device ms by category over `steps` ResNet train steps
    (`phased_profile`)."""
    return phased_profile(net, lambda live: net._score_fn(
        live, net.state, net._as_inputs(mds.features),
        net._as_labels(mds.labels), None, None, True, gen), steps)


def phased_profile(net, score, steps=2):
    """Device ms by category over `steps` train steps, each split by
    synchronisations into forward, backward and optimizer (the step's own
    calls: `score(live params)` -> (loss, (new state, ...)), autograd, the
    updater chain); a kernel belongs to the phase whose host range holds
    its start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from deeplearning4j_tpu_torch.nn.updaters import (
        apply_updates, tree_leaves, tree_map,
    )
    losses = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            live = tree_map(lambda t: t.detach().requires_grad_(True),
                            net.params)
            leaves = tree_leaves(live)
            with record_function("step/forward"):
                loss, (new_state, _) = score(live)
                torch.cuda.synchronize()
            with record_function("step/backward"):
                grads = torch.autograd.grad(loss, leaves)
                torch.cuda.synchronize()
            by_leaf = {id(t): g for t, g in zip(leaves, grads)}
            grad_tree = tree_map(lambda t: by_leaf[id(t)], live)
            with record_function("step/optimizer"), torch.no_grad():
                updates, net.opt_state = net._tx.update(
                    grad_tree, net.opt_state, net.params)
                apply_updates(net.params, updates)
                torch.cuda.synchronize()
            net.state = tree_map(lambda t: t.detach(), new_state)
            losses.append(float(loss.detach()))
    events = profiler_events(prof)
    # the host's ranges; the profiler also puts each range on the device
    # timeline (a span over its kernels), which is not a kernel
    ranges = [(e.start_us, e.end_us, e.name.split("/")[1])
              for e in events if e.name.startswith("step/")
              and e.device_type == DeviceType.CPU]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("step/")]
    if not kernels or not ranges:
        return {"device_time": "not measured"}, losses
    by_cat, by_name, unplaced = {}, {}, 0
    for e in kernels:
        phase = next((p for a, b, p in ranges
                      if a <= e.start_us <= b), None)
        if phase is None:
            unplaced += 1
            continue
        cat = _resnet_category(e.name, phase)
        ms = e.us / 1e3
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
        key = (cat, e.name[:70])
        by_name[key] = by_name.get(key, 0.0) + ms
    top = {}
    for (cat, name), ms in sorted(by_name.items(), key=lambda kv: -kv[1]):
        if len(top.setdefault(cat, [])) < 3:
            top[cat].append([name, ms / steps])
    return {"steps": steps, "device_ms_per_step_by_category":
            {k: v / steps for k, v in sorted(by_cat.items())},
            "device_ms_per_step": sum(by_cat.values()) / steps,
            "top_kernels_ms_per_step": top,
            "kernels_outside_the_phases": unplaced}, losses


def timed_fit_steps(net, batch, warmup, timed):
    """Per-call fit steps on one batch by CUDA events: (losses, step ms,
    host ms); the peak memory counter is reset first."""
    losses, step_ms, host_ms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup + timed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        net.fit(batch)                     # ends in the step's loss fetch
        end.record()
        end.synchronize()
        losses.append(net.score())
        if i >= warmup:
            step_ms.append(start.elapsed_time(end))
            host_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms, host_ms


def resnet_timed(compute_dtype):
    """Phase 6c: the zoo ResNet50 at the bench shape, per-call fit steps
    on one seeded batch on the card, timed by CUDA events; then the
    profiles, the sync count and the rest of RESNET_STEPS steps."""
    import dataclasses
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = ResNet50().conf()
    if compute_dtype is not None:
        conf = dataclasses.replace(conf, compute_dtype=compute_dtype)
    net = ComputationGraph(conf).init()
    g = torch.Generator(device="cuda").manual_seed(2024)
    x = torch.rand(RESNET_BATCH, RESNET_HW, RESNET_HW, 3, generator=g,
                   device="cuda")
    y = torch.nn.functional.one_hot(
        torch.randint(0, 1000, (RESNET_BATCH,), generator=g, device="cuda"),
        1000).float()
    mds = MultiDataSet((x,), (y,))
    losses, step_ms, host_ms = timed_fit_steps(net, mds, RESNET_WARMUP,
                                               RESNET_TIMED)
    peak = torch.cuda.max_memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(5)
    prof = profile_steps(net, mds, gen)
    prof["phase"] = "resnet_profile"
    losses += [None] * prof.get("steps", 2)   # not fetched one by one
    phased, phased_losses = resnet_phased_profile(net, mds, gen)
    losses += phased_losses
    syncs = count_syncs(lambda: float(net._train_step(mds, gen)))
    losses.append(None)
    while len(losses) < RESNET_STEPS:
        net.fit(mds)
        losses.append(net.score())
    p50 = statistics.median(step_ms)
    tflops = RESNET_FLOP_PER_IMAGE * RESNET_BATCH / (p50 / 1e3) / 1e12
    dtype = compute_dtype or "float32"
    peak_rate = peak_flops(dtype)
    steps = prof.get("steps", 2)
    row = {"phase": "resnet_timed", "compute_dtype": dtype,
           "params": net.num_params(), "batch": RESNET_BATCH,
           "image": [RESNET_HW, RESNET_HW, 3], "classes": 1000,
           "updater": "Nesterovs(0.1, 0.9)", "l2": 1e-4,
           "cudnn_benchmark": torch.backends.cudnn.benchmark,
           "step_ms_p50": p50, "step_ms_max": max(step_ms),
           "step_ms": step_ms, "step_host_ms_p50": statistics.median(host_ms),
           "imgs_per_s": RESNET_BATCH / (p50 / 1e3),
           "tflops_at_24.6_gflop_per_image": tflops,
           "peak_tflops": peak_rate / 1e12,
           "share_of_peak": tflops * 1e12 / peak_rate,
           "launches_per_step": prof.get("kernel_launches", 0) / steps,
           "syncs_per_step": syncs,
           "idle_share": prof.get("idle_share", "not measured"),
           # the host sets the pace when the device waits a quarter of
           # the step or more
           "paced_by": "host" if prof.get("idle_share", 0.0) >= 0.25
           else "device",
           "device_busy_ms_per_step": prof["device_busy_ms"] / steps
           if "device_busy_ms" in prof else "not measured",
           "by_category": phased, "peak_memory_bytes": peak,
           "losses": losses}
    emit(prof)
    emit(row)
    del net, mds, x, y
    torch.cuda.empty_cache()
    return row


def resnet_loss_fall():
    """The f32 loss over RESNET_STEPS per-call steps on resnet_timed's one
    seeded batch, with cuDNN's deterministic algorithms: at lr 0.1 the
    trajectory is chaotic (it climbs to ~20 before it falls), and with
    the default algorithms, whose backward sums in a varying order, where
    it ends after 20 steps changes from run to run; this one repeats."""
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    net = ComputationGraph(ResNet50().conf()).init()
    g = torch.Generator(device="cuda").manual_seed(2024)
    x = torch.rand(RESNET_BATCH, RESNET_HW, RESNET_HW, 3, generator=g,
                   device="cuda")
    y = torch.nn.functional.one_hot(
        torch.randint(0, 1000, (RESNET_BATCH,), generator=g, device="cuda"),
        1000).float()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    losses = []
    try:
        for _ in range(RESNET_STEPS):
            net.fit(MultiDataSet((x,), (y,)))
            losses.append(net.score())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del net
    torch.cuda.empty_cache()
    return losses


def resnet(fa, tmp):
    """Phase 6: ResNet-50 through the ComputationGraph, counted from zero:
    parity with the CPU, the train CLI, the timed steps, and the f32 loss
    falling over RESNET_STEPS deterministic steps."""
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    parity = resnet_parity(tmp)
    cli_row = resnet_cli(tmp)
    timed = {"float32": resnet_timed(None),
             "bfloat16": resnet_timed("bfloat16")}
    falling = resnet_loss_fall()
    launches = dict(fa.KERNEL_LAUNCHES)
    f32, bf16 = ([s for s in timed[d]["losses"] if s is not None]
                 for d in ("float32", "bfloat16"))
    if len(falling) != RESNET_STEPS or \
            len(timed["float32"]["losses"]) != RESNET_STEPS or \
            not np.isfinite(f32 + bf16 + falling).all() or \
            not falling[-1] < falling[0]:
        raise AssertionError(f"ResNet50 f32 loss over {RESNET_STEPS} "
                             f"deterministic steps: {falling}")
    if any(launches.values()):
        raise AssertionError(f"flash kernels launched on the ResNet path: "
                             f"{launches}")
    summary = {"phase": "resnet", "gpu": gpu_line(),
               "seconds": time.perf_counter() - t0,
               "flash_launches": launches,
               "first_loss_f32": falling[0], "last_loss_f32": falling[-1],
               "losses_f32_deterministic": falling,
               **{f"{d}_{k}": timed[d][k] for d in timed
                  for k in ("step_ms_p50", "imgs_per_s",
                            "tflops_at_24.6_gflop_per_image", "idle_share",
                            "paced_by", "launches_per_step",
                            "peak_memory_bytes")}}
    emit(summary)
    return {"launches": launches, "parity": parity, "cli": cli_row,
            "timed": timed}


# the fit_graph phase: the reference bench's "fit" mode (bench.py:320-345):
# fit(iterator, scan_steps=K) over uint8 images with an
# ImagePreProcessingScaler, two chunks of K a fit
FIT_K = 10
LM_SCAN_K, LM_SCAN_STEPS = 8, 16
# host-side CUDA API calls that put work on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def launch_profile(fn, steps):
    """fn() under torch.profiler: per step the host's launch calls, the
    device's kernels (memcopies apart) and busy ms, each flash kernel's
    count, and the device's idle share of the host's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = profiler_events(prof)
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    kernels = [e for e in device if not e.name.startswith("Memcpy")
               and not e.name.startswith("Memset")]
    launches = [e for e in events if e.device_type == DeviceType.CPU
                and e.name in LAUNCH_CALLS]
    busy_ms = sum(e.us for e in device) / 1e3
    if not device:
        return {"device_time": "not measured", "wall_ms": wall_ms}
    return {"steps": steps, "wall_ms": wall_ms,
            "host_launch_calls_per_step": len(launches) / steps,
            "graph_launches_per_step": sum(
                e.name == "cudaGraphLaunch" for e in launches) / steps,
            "device_kernels_per_step": len(kernels) / steps,
            "device_busy_ms_per_step": busy_ms / steps,
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
            "flash_kernels_per_step": {
                k: sum(k in e.name for e in kernels) / steps
                for k in KERNELS}}


def merged_profile(windows):
    """launch_profile rows of equal-length windows as one: per-step
    figures averaged, wall summed, the idle share over the sum; each
    window's flash counts kept beside."""
    if any("steps" not in w for w in windows):
        return {"device_time": "not measured",
                "wall_ms": sum(w["wall_ms"] for w in windows)}
    n = len(windows)
    wall = sum(w["wall_ms"] for w in windows)
    busy = sum(w["device_busy_ms_per_step"] * w["steps"] for w in windows)
    out = {"steps": sum(w["steps"] for w in windows), "wall_ms": wall,
           "windows": n, "idle_share": max(0.0, 1.0 - busy / wall)}
    for key in ("host_launch_calls_per_step", "graph_launches_per_step",
                "device_kernels_per_step", "device_busy_ms_per_step"):
        out[key] = sum(w[key] for w in windows) / n
    out["flash_kernels_per_step"] = {
        k: sum(w["flash_kernels_per_step"][k] for w in windows) / n
        for k in KERNELS}
    out["flash_kernels_by_window"] = [
        {k: w["flash_kernels_per_step"][k] * w["steps"] for k in KERNELS}
        for w in windows]
    return out


def sync_sites(fn):
    """Host-device synchronisations during fn(), as CUDA's sync debug
    mode reports them, each by where it happened: inside a chunk's
    dispatch (must not happen), in a chunk's deferred loss fetch, or
    elsewhere (fit's own set-up)."""
    import traceback
    sites = {"dispatch": 0, "chunk_loss_fetch": 0, "other": 0}
    where = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        names = [f.name for f in traceback.extract_stack()]
        site = "dispatch" if "dispatch" in names else \
            "chunk_loss_fetch" if "_process" in names else "other"
        sites[site] += 1
        if site != "chunk_loss_fetch":
            where.append([f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} "
                          f"{f.name}" for f in traceback.extract_stack()
                          if "site-packages" not in f.filename][-4:])

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        saved, warnings.showwarning = warnings.showwarning, hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = saved
    return sites, where[:4]


def resnet_fit(compute_dtype):
    """Phase 7a: ResNet-50 at the bench shape through
    ComputationGraph.fit(iterator, scan_steps=FIT_K): uint8 pixels, the
    scaler as a device affine, prefetch on, two chunks a fit. The same
    net's per-call fit (scan_steps=1, the same pipeline) runs first, for
    its numbers beside."""
    import dataclasses
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.normalization import (
        ImagePreProcessingScaler,
    )
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = ResNet50().conf()
    if compute_dtype is not None:
        conf = dataclasses.replace(conf, compute_dtype=compute_dtype)
    net = ComputationGraph(conf).init()
    rs = np.random.RandomState(2024)
    x8 = rs.randint(0, 256, (RESNET_BATCH, RESNET_HW, RESNET_HW, 3),
                    dtype=np.uint8)
    y = np.eye(1000, dtype=np.float32)[rs.randint(0, 1000, RESNET_BATCH)]
    batches = [DataSet(x8, y)] * (2 * FIT_K)

    def make_it(n=2 * FIT_K):
        return ExistingDataSetIterator(batches[:n]).set_pre_processor(
            ImagePreProcessingScaler())

    def timed(scan, n=2 * FIT_K):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(make_it(n), scan_steps=scan)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    dtype = compute_dtype or "float32"
    rows = {}
    for mode, scan in (("per_call", 1), ("graph", FIT_K)):
        # the peak over the first fit too: the graph's pool is allocated
        # at capture
        torch.cuda.reset_peak_memory_stats()
        first_ms = timed(scan, 2 if scan == 1 else 2 * FIT_K)  # warm/capture
        walls = [timed(scan) for _ in range(RESNET_FIT_TIMED)]
        peak = torch.cuda.max_memory_allocated()
        # the profiler's window is one chunk (its events take seconds
        # to read back); the syncs are counted over a whole fit
        n_prof = 4 if scan == 1 else FIT_K
        prof = launch_profile(lambda: net.fit(make_it(n_prof),
                                              scan_steps=scan), n_prof)
        n_sync = 4 if scan == 1 else 2 * FIT_K
        sites, where = sync_sites(lambda: net.fit(make_it(n_sync),
                                                  scan_steps=scan))
        wall = statistics.median(walls)
        step_ms = wall / (2 * FIT_K)
        rows[mode] = {
            "scan_steps": scan, "first_fit_ms": first_ms,
            "fit_wall_ms": walls, "chunk_wall_ms_median": wall / 2,
            "step_ms": step_ms, "step_ms_min": min(walls) / (2 * FIT_K),
            "imgs_per_s": RESNET_BATCH / (step_ms / 1e3),
            "tflops_at_24.6_gflop_per_image":
                RESNET_FLOP_PER_IMAGE * RESNET_BATCH / (step_ms / 1e3) / 1e12,
            "peak_memory_bytes": peak,
            "allocated_bytes_after": torch.cuda.memory_allocated(),
            "syncs_per_fit": sites, "sync_sites": where, **prof}
    graph = rows["graph"]
    ok = (np.isfinite(net.score()) and graph["syncs_per_fit"]["dispatch"] == 0
          and graph["syncs_per_fit"]["chunk_loss_fetch"] <= 2)
    row = {"phase": "resnet_fit", "compute_dtype": dtype,
           "params": net.num_params(), "batch": RESNET_BATCH,
           "image": [RESNET_HW, RESNET_HW, 3], "input": "uint8 + "
           "ImagePreProcessingScaler (device affine)", "prefetch": True,
           "chunks_per_fit": 2, "score": net.score(), "ok": ok, **rows}
    emit(row)
    if not ok:
        raise AssertionError(f"resnet fit {dtype}: {row}")
    del net
    torch.cuda.empty_cache()
    return row


def train_scan(fa):
    """Phase 7b: the full-width LM through fit(scan_steps=LM_SCAN_K) over
    LM_SCAN_STEPS steps (two chunks): each captured step must run each
    flash kernel n_layers times (the profiler's kernel events; the
    wrappers' counters see only the warm-up step and the capture)."""
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.registry import parse_zoo_source
    name, kw = parse_zoo_source(LM_SOURCE[len("zoo:"):])
    net = model_by_name(name, **kw).init()
    rs = np.random.RandomState(77)
    n = LM_SCAN_STEPS * TRAIN_BATCH
    seq = (rs.randint(0, VOCAB, (n, 1))
           + rs.randint(1, 8, (n, 1)) * np.arange(SEQ + 1)) % VOCAB
    x = seq[:, :SEQ, None].astype("float32")
    y = np.zeros((n, SEQ, VOCAB), np.uint8)
    np.put_along_axis(y, seq[:, 1:, None], 1, axis=-1)

    def fit(scan, steps=LM_SCAN_STEPS):
        n_rows = steps * TRAIN_BATCH
        net.fit(ArrayDataSetIterator(x[:n_rows], y[:n_rows],
                                     batch_size=TRAIN_BATCH),
                scan_steps=scan)

    def timed(scan):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(scan)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / LM_SCAN_STEPS

    rows = {}
    for mode, scan in (("per_call", 1), ("graph", LM_SCAN_K)):
        for k in KERNELS:
            fa.KERNEL_LAUNCHES[k] = 0
        torch.cuda.reset_peak_memory_stats()
        first = timed(scan)                  # warm-up / capture
        counted = dict(fa.KERNEL_LAUNCHES)
        steps = [timed(scan) for _ in range(2)]
        peak = torch.cuda.max_memory_allocated()
        # one profiler window of one chunk (LM_SCAN_K steps): one window
        # over all 16 replayed steps once came back a backward kernel
        # short (ROADMAP M.1)
        prof = merged_profile([launch_profile(
            lambda: fit(scan, LM_SCAN_K), LM_SCAN_K)])
        sites, where = sync_sites(lambda: fit(scan))
        step_ms = statistics.median(steps)
        rows[mode] = {"scan_steps": scan, "first_fit_step_ms": first,
                      "step_ms_by_fit": steps, "step_ms": step_ms,
                      "tokens_per_s": TRAIN_BATCH * SEQ / (step_ms / 1e3),
                      "wrapper_counts_first_fit": counted,
                      "peak_memory_bytes": peak,
                      "allocated_bytes_after": torch.cuda.memory_allocated(),
                      "syncs_per_fit": sites, "sync_sites": where, **prof}
    graph = rows["graph"]
    flash = graph.get("flash_kernels_per_step", {})
    ok = (np.isfinite(net.score())
          and all(flash.get(k) == N_LAYERS for k in KERNELS)
          and graph["syncs_per_fit"]["dispatch"] == 0
          and graph["syncs_per_fit"]["chunk_loss_fetch"] <= 2)
    row = {"phase": "train_scan", "source": LM_SOURCE, "steps":
           LM_SCAN_STEPS, "batch": TRAIN_BATCH, "seq": SEQ,
           "score": net.score(), "ok": ok, **rows}
    emit(row)
    if not ok:
        raise AssertionError(f"LM scan fit: {row}")
    del net
    torch.cuda.empty_cache()
    return {k: int(flash.get(k, 0) * LM_SCAN_STEPS) for k in KERNELS}


def _bitwise(a_tree, b_tree) -> bool:
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a_tree),
                                                 tree_leaves(b_tree)))


def fit_equality(tmp):
    """Phase 7c: graph against per-call from one init on the card, and the
    card against the CPU in f64:
    - the full-width LM, LM_SCAN_STEPS steps: parameters bitwise equal;
    - a small MLP with dropout 0.5 (the registered dropout generator):
      bitwise;
    - ResNet50 at RESNET_PARITY, batch 4, two chunks of 3, cuDNN
      deterministic: parameters and BN state bitwise (or, if capture
      picks another algorithm, within 1e-5 of each update, reported);
    - f64 at RESNET_PARITY: one update of accumulate_steps=2, card
      against CPU, every leaf within 1e-12 of its update; scan_steps=2
      over two chunks bitwise equal to per-call steps on the card;
    - evaluate() of one network on the card and on the CPU: equal
      accuracy and confusion matrix."""
    import dataclasses
    import os
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import (
        ArrayDataSetIterator, ExistingDataSetIterator,
    )
    from deeplearning4j_tpu_torch.data.normalization import (
        ImagePreProcessingScaler,
    )
    from deeplearning4j_tpu_torch.models.zoo import ResNet50, model_by_name
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam, tree_map
    from deeplearning4j_tpu_torch.serving.registry import parse_zoo_source
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    out = {"phase": "fit_equality"}
    # the LM
    name, kw = parse_zoo_source(LM_SOURCE[len("zoo:"):])
    rs = np.random.RandomState(5)
    n = LM_SCAN_STEPS * TRAIN_BATCH
    seq = rs.randint(0, VOCAB, (n, SEQ + 1))
    x, y = seq[:, :SEQ, None].astype("float32"), seq[:, 1:]
    y1 = np.zeros((n, SEQ, VOCAB), np.uint8)
    np.put_along_axis(y1, y[..., None], 1, axis=-1)
    nets = []
    for scan in (1, LM_SCAN_K):
        net = model_by_name(name, **kw).init()
        net.fit(ArrayDataSetIterator(x, y1, batch_size=TRAIN_BATCH),
                scan_steps=scan)
        nets.append(net)
    out["lm_bitwise"] = _bitwise(nets[0].params, nets[1].params)
    del nets
    torch.cuda.empty_cache()
    # dropout through the registered generator
    mconf = (NeuralNetConfiguration.Builder().seed(7).updater(Adam(1e-2))
             .list().layer(DenseLayer(n_out=64, activation="relu",
                                      dropout=0.5))
             .layer(OutputLayer(n_out=3, activation="softmax",
                                loss="mcxent"))
             .set_input_type(InputType.feed_forward(16)).build())
    xm = rs.randn(640, 16).astype("float32")
    ym = np.eye(3, dtype="float32")[rs.randint(0, 3, 640)]
    nets = []
    for scan in (1, 4):
        net = MultiLayerNetwork(mconf).init()
        net.fit(ArrayDataSetIterator(xm, ym, batch_size=64), epochs=2,
                scan_steps=scan)
        nets.append(net)
    out["dropout_mlp_bitwise"] = _bitwise(nets[0].params, nets[1].params)
    # ResNet50 at the parity config, graph against per-call
    hw = RESNET_PARITY["input_shape"][0]
    x8 = rs.randint(0, 256, (24, hw, hw, 3), dtype=np.uint8)
    yr = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 24)]
    batches = [DataSet(x8[i:i + 4], yr[i:i + 4]) for i in range(0, 24, 4)]
    src = ComputationGraph(ResNet50(**RESNET_PARITY).conf()).init()
    path = save_model(src, os.path.join(tmp, "parity.zip"), compression=STORED)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        nets = []
        for scan in (1, 3):
            net = load_model(path)
            net.fit(ExistingDataSetIterator(batches).set_pre_processor(
                ImagePreProcessingScaler()), scan_steps=scan)
            nets.append(net)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    before = dict(iter_leaves(load_model(path, device="cpu").params))
    out["resnet_parity_bitwise"] = (_bitwise(nets[0].params, nets[1].params)
                                    and _bitwise(nets[0].state,
                                                 nets[1].state))
    out["resnet_parity_err_over_update"] = _leaf_errors(
        nets[1].params, tree_map(lambda t: t.cpu(), nets[0].params), before)
    # evaluate on the card and on the CPU, one network
    xe = (x8.astype(np.float32) / 255)[:16]
    card_ev = load_model(path).evaluate(DataSet(xe, yr[:16]), batch_size=8)
    cpu_ev = load_model(path, device="cpu").evaluate(DataSet(xe, yr[:16]),
                                                     batch_size=8)
    out["evaluate_accuracy"] = [card_ev.accuracy(), cpu_ev.accuracy()]
    out["evaluate_equal"] = bool(
        card_ev.accuracy() == cpu_ev.accuracy()
        and np.array_equal(card_ev.confusion.matrix,
                           cpu_ev.confusion.matrix))
    # f64 at the parity config. One update of accumulate_steps=2 (its
    # second micro-step replays the captured micro-step), card against
    # CPU within 1e-12 of the update. Scan over two chunks of 2: the
    # card's graph steps bitwise equal to its per-call steps, both
    # against the CPU after 4 updates (training drifts the devices apart
    # step by step, per-call alike, so that error is reported, not held
    # to 1e-12)
    conf64 = dataclasses.replace(ResNet50(**RESNET_PARITY).conf(),
                                 dtype="float64")
    path64 = save_model(ComputationGraph(conf64, device="cpu").init(),
                        os.path.join(tmp, "parity64.zip"),
                        save_updater=False, compression=STORED)
    x64 = (x8[:16].astype(np.float64) / 255)
    b64 = [DataSet(x64[i:i + 4], yr[i:i + 4].astype(np.float64))
           for i in range(0, 16, 4)]
    before64 = dict(iter_leaves(load_model(path64, device="cpu").params))
    card, cpu = load_model(path64), load_model(path64, device="cpu")
    card.fit(ExistingDataSetIterator(b64[:2]), accumulate_steps=2)
    cpu.fit(ExistingDataSetIterator(b64[:2]), accumulate_steps=2)
    out["accumulate_f64_err_over_update"] = _leaf_errors(
        card.params, cpu.params, before64)
    out["accumulate_f64_scores"] = [card.score(), cpu.score()]
    out["accumulate_f64_iterations"] = [card.iteration_count,
                                        cpu.iteration_count]
    out["accumulate_f64_bn_state_err"] = _leaf_errors(card.state, cpu.state)
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for scan in (1, 2):
            net = load_model(path64)
            net.fit(ExistingDataSetIterator(b64), scan_steps=scan)
            runs[scan] = net
    finally:
        torch.backends.cudnn.deterministic = deterministic
    cpu = load_model(path64, device="cpu")
    cpu.fit(ExistingDataSetIterator(b64))
    out["scan_f64_bitwise_per_call"] = (
        _bitwise(runs[1].params, runs[2].params)
        and _bitwise(runs[1].state, runs[2].state))
    out["scan_f64_4_steps_err_over_update"] = {
        f"scan_steps={k}": _leaf_errors(n.params, cpu.params, before64)
        for k, n in runs.items()}
    out["ok"] = bool(
        out["lm_bitwise"] and out["dropout_mlp_bitwise"]
        and (out["resnet_parity_bitwise"]
             or out["resnet_parity_err_over_update"] <= 1e-5)
        and out["evaluate_equal"]
        and out["accumulate_f64_iterations"] == [1, 1]
        and out["accumulate_f64_err_over_update"] <= 1e-12
        and out["scan_f64_bitwise_per_call"])
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"fit_graph equality: {out}")
    return out


def fit_graph(fa, tmp):
    """Phase 7: the reference's production fit loop on the card, counted
    from zero: ResNet-50's fit mode in f32 and bf16, the LM's scan fit,
    and the equality checks."""
    t0 = time.perf_counter()
    rows = {"float32": resnet_fit(None), "bfloat16": resnet_fit("bfloat16")}
    flash = train_scan(fa)
    equality = fit_equality(tmp)
    summary = {"phase": "fit_graph", "gpu": gpu_line(),
               "seconds": time.perf_counter() - t0,
               "train_graph_flash_launches": flash,
               **{f"{d}_{m}_{k}": rows[d][m][k] for d in rows
                  for m in ("per_call", "graph")
                  for k in ("step_ms", "imgs_per_s", "idle_share",
                            "host_launch_calls_per_step",
                            "peak_memory_bytes")
                  if k in rows[d][m]},
               "equality_ok": equality["ok"]}
    emit(summary)
    return {"train_graph": flash, "resnet": rows, "equality": equality}


# the rnn phase: the zoo's TextGenerationLSTM at the sizes of DL4J's
# GravesLSTMCharModellingExample (sequences of 1000 characters, minibatch
# 32, tbptt 50), and bench.py's char-LSTM at its chip sizes
# (_run_char_lstm: 2 x LSTM(200), 77 characters, T = 50, batch 64,
# Adam(1e-3), standard backprop)
CHARS, CHAR_SEQ, CHAR_BATCH, CHAR_SEQS, TBPTT = 47, 1000, 32, 64, 50
STREAM_PRIME, STREAM_STEPS = 50, 200
BENCH_VOCAB, BENCH_UNITS, BENCH_T, BENCH_BATCH, RNN_K = 77, 200, 50, 64, 10
# char_lstm_fit's timed fits a mode (cut to two for the run's time limit)
CHAR_FIT_TIMED = 2


def char_sequences(rs, n, t, vocab):
    """A learnable character set: each row an arithmetic sequence mod
    `vocab` (seeded start, stride 1-3); one-hot f32 features and the next
    character one-hot as uint8 labels."""
    start = rs.randint(0, vocab, (n, 1))
    stride = rs.randint(1, 4, (n, 1))
    ids = (start + stride * np.arange(t + 1)) % vocab
    eye = np.eye(vocab, dtype=np.uint8)
    return eye[ids[:, :-1]].astype(np.float32), eye[ids[:, 1:]]


def rnn_parity(tmp):
    """Phase 8a: card against CPU. A small LSTM + GravesLSTM +
    Bidirectional(LSTM) net from one zip: output() and a masked forward in
    f32 within 1e-5; two tbptt chunks (T = 12, chunks of 6, a masked tail
    across the boundary) in f64, every parameter within 1e-10 of its
    largest update; check_gradients in f64 on the card for a masked
    GravesLSTM."""
    import dataclasses
    import os
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.gradientcheck import check_gradients
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        LSTM, Bidirectional, GravesLSTM, RnnOutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    conf = (NeuralNetConfiguration.Builder().seed(11).updater(Adam(1e-2))
            .list().layer(LSTM(n_out=8)).layer(GravesLSTM(n_out=6))
            .layer(Bidirectional(layer=LSTM(n_out=5)))
            .layer(RnnOutputLayer(n_out=3))
            .set_input_type(InputType.recurrent(4, 12)).tbptt(6).build())
    rs = np.random.RandomState(8)
    x = rs.randn(4, 12, 4).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, (4, 12))]
    m = np.ones((4, 12), np.float32)
    m[:2, 4:] = 0                       # masked from inside chunk 1 on
    path = save_model(MultiLayerNetwork(conf, device="cpu").init(),
                      os.path.join(tmp, "rnn.zip"))
    card, cpu = load_model(path), load_model(path, device="cpu")
    out = {"phase": "rnn_parity",
           "output_f32_max_abs_err":
               (card.output(x).cpu() - cpu.output(x)).abs().max().item()}
    with torch.no_grad():
        masked = [n._forward(n.params, n.state, torch.from_numpy(x).to(
            n.device), False, fmask=torch.from_numpy(m).to(n.device))[0]
            for n in (card, cpu)]
    out["masked_forward_f32_max_abs_err"] = \
        (masked[0].cpu() - masked[1]).abs().max().item()
    path64 = save_model(
        MultiLayerNetwork(dataclasses.replace(conf, dtype="float64"),
                          device="cpu").init(),
        os.path.join(tmp, "rnn64.zip"), save_updater=False)
    card, cpu = load_model(path64), load_model(path64, device="cpu")
    before = {k: v.clone() for k, v in iter_leaves(cpu.params)}
    batch = DataSet(x.astype(np.float64), y.astype(np.float64), m, m)
    for net in (card, cpu):
        net.fit(batch, prefetch=False)
    out["tbptt_f64_iterations"] = [card.iteration_count, cpu.iteration_count]
    out["tbptt_f64_err_over_update"] = _leaf_errors(card.params, cpu.params,
                                                    before)
    gconf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-2))
             .list().layer(GravesLSTM(n_out=5))
             .layer(RnnOutputLayer(n_out=2))
             .set_input_type(InputType.recurrent(4, 5)).build())
    gx = rs.rand(3, 5, 4).astype(np.float32)
    gy = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (3, 5))]
    gm = np.ones((3, 5), np.float32)
    gm[1, 3:] = 0
    gm[2, 2:] = 0
    res = check_gradients(MultiLayerNetwork(gconf).init(), gx, gy,
                          features_mask=gm, max_per_param=8)
    out.update({"gradcheck_passed": res.passed,
                "gradcheck_entries": res.n_params_checked,
                "gradcheck_max_rel_error": res.max_rel_error})
    out["ok"] = bool(out["output_f32_max_abs_err"] <= 1e-5
                     and out["masked_forward_f32_max_abs_err"] <= 1e-5
                     and out["tbptt_f64_iterations"] == [2, 2]
                     and out["tbptt_f64_err_over_update"] <= 1e-10
                     and res.passed)
    emit(out)
    if not out["ok"]:
        raise AssertionError(f"rnn card against CPU: {out}")
    return out


def syncs_of(fn) -> int:
    """Host-device synchronisations during fn(), as CUDA's sync debug mode
    reports them."""
    sites, _ = sync_sites(fn)
    return sum(sites.values())


def rnn_cli(tmp):
    """Phase 8b: the zoo's full-width TextGenerationLSTM at
    max_length=CHAR_SEQ through train.cli.main (batch 32 over 64 seeded
    sequences: 2 batches x 20 chunks = 40 iterations); the result line,
    the reloaded zip and a falling loss. Then tbptt chunk steps on one
    batch resident on the card: chunk ms by CUDA events, chars/s, peak
    memory; launches, device busy and idle share of two chunks
    (torch.profiler), syncs a chunk. Returns the trained net and its
    numbers."""
    import contextlib
    import os
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM
    from deeplearning4j_tpu_torch.train import cli as train_cli
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    src, out_zip = os.path.join(tmp, "charlstm.zip"), os.path.join(
        tmp, "charlstm_out.zip")
    data = os.path.join(tmp, "chars.npz")
    model = TextGenerationLSTM(max_length=CHAR_SEQ)
    save_model(model.init(), src)
    features, labels = char_sequences(np.random.RandomState(47), CHAR_SEQS,
                                      CHAR_SEQ, CHARS)
    np.savez(data, features=features, labels=labels)
    log = logging.getLogger("deeplearning4j_tpu_torch")
    handler, level = _ScoreLog(), log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    stdout = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout):
            code = train_cli.main([
                "--model", src, "--output", out_zip, "--dataset", data,
                "--mode", "single", "--batch-size", str(CHAR_BATCH),
                "--score-every", "1"])
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    wall_s = time.perf_counter() - t0
    lines = stdout.getvalue().strip().splitlines()
    result = json.loads(lines[-1])
    chunks = CHAR_SEQ // TBPTT
    want = CHAR_SEQS // CHAR_BATCH * chunks
    scores = handler.scores
    if code != 0 or result["iterations"] != want or result["epochs"] != 1:
        raise AssertionError(f"char-LSTM CLI: exit {code}, {lines[-1]}")
    # the second batch's chunks against the first's: each batch starts
    # from the zero state, so chunk k of one is compared with chunk k of
    # the other
    falling = bool(np.mean(scores[chunks:]) < np.mean(scores[:chunks]))
    if len(scores) != want or not all(np.isfinite(scores)) or not falling:
        raise AssertionError(f"char-LSTM scores {scores}")
    net = load_model(out_zip)
    if net.iteration_count != want or \
            int(net.opt_state["1"]["0"]["count"]) != want:
        raise AssertionError("the char-LSTM zip lost its counters or "
                             "updaterState.bin")
    ds = DataSet(torch.from_numpy(features[:CHAR_BATCH]).cuda(),
                 torch.from_numpy(labels[:CHAR_BATCH]).cuda())
    net.fit(ds, prefetch=False)                          # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # earlier phases' tensors too
    walls = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        net.fit(ds, prefetch=False)
        end.record()
        end.synchronize()
        walls.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    chunk_ms = statistics.median(walls) / chunks
    two = DataSet(ds.features[:, :2 * TBPTT], ds.labels[:, :2 * TBPTT])
    prof = launch_profile(lambda: net.fit(two, prefetch=False), 2)
    syncs = syncs_of(lambda: net.fit(two, prefetch=False)) / 2
    row = {"phase": "rnn_cli", "params": net.num_params(),
           "chars": CHARS, "seq": CHAR_SEQ, "batch": CHAR_BATCH,
           "tbptt": TBPTT, "iterations": result["iterations"],
           "cli_wall_s": wall_s, "first_score": scores[0],
           "last_score": scores[-1],
           "mean_score_batch_1": float(np.mean(scores[:chunks])),
           "mean_score_batch_2": float(np.mean(scores[chunks:])),
           "fit_ms_by_events": walls, "chunk_ms": chunk_ms,
           "chars_per_s": CHAR_BATCH * TBPTT / (chunk_ms / 1e3),
           "syncs_per_chunk": syncs, "peak_memory_bytes": peak,
           "allocated_bytes_before": held, "profile_of_two_chunks": prof}
    emit(row)
    return net, row


def rnn_stream(net):
    """Phase 8c: the trained char-LSTM streams: primed with STREAM_PRIME
    characters in one rnn_time_step call, then STREAM_STEPS one-step calls
    at batch 1; the stepped outputs must equal output() of the whole
    sequence within 1e-5 (f32). Call ms by CUDA events (the calls queued
    back to back), and with each step's output fetched to the host, as a
    sampler would; one call's launches and idle share."""
    feats, _ = char_sequences(np.random.RandomState(99), 1,
                              STREAM_PRIME + STREAM_STEPS, CHARS)
    x = torch.from_numpy(feats).cuda()
    full = net.output(x)
    net.rnn_clear_previous_state()
    outs = [net.rnn_time_step(x[:, :STREAM_PRIME])]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for t in range(STREAM_PRIME, STREAM_PRIME + STREAM_STEPS):
        outs.append(net.rnn_time_step(x[:, t])[:, None])
    end.record()
    end.synchronize()
    queued_ms = start.elapsed_time(end) / STREAM_STEPS
    err = (torch.cat(outs, 1) - full).abs().max().item()
    net.rnn_clear_previous_state()
    net.rnn_time_step(x[:, :STREAM_PRIME])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(STREAM_PRIME, STREAM_PRIME + STREAM_STEPS):
        net.rnn_time_step(x[:, t]).cpu()
    fetched_ms = (time.perf_counter() - t0) * 1e3 / STREAM_STEPS
    prof = launch_profile(lambda: net.rnn_time_step(x[:, 0]), 1)
    row = {"phase": "rnn_stream", "prime": STREAM_PRIME,
           "calls": STREAM_STEPS, "batch": 1,
           "max_abs_err_vs_output": err, "call_ms_queued": queued_ms,
           "call_ms_fetched": fetched_ms, "profile_of_one_call": prof}
    row["ok"] = bool(err <= 1e-5)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"rnn_time_step against output(): {row}")
    return row


def char_lstm_fit():
    """Phase 8d: bench.py's char-LSTM at its chip sizes, f32, standard
    backprop, through fit(scan_steps=1) then fit(scan_steps=RNN_K) on one
    net, two chunks of RNN_K a fit: step ms, chars/s, host launch calls,
    device kernels, device busy and idle share a step, syncs by site, peak
    memory; and, from one init, the graph steps bitwise equal to the
    per-call steps. (e) beside it: torch.nn.LSTM (cuDNN) forward and
    backward at the same shape, a yardstick the port never calls."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import LSTM, RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Adam(1e-3))
            .list().layer(LSTM(n_out=BENCH_UNITS, activation="tanh"))
            .layer(LSTM(n_out=BENCH_UNITS, activation="tanh"))
            .layer(RnnOutputLayer(n_out=BENCH_VOCAB, activation="softmax",
                                  loss="mcxent"))
            .set_input_type(InputType.recurrent(BENCH_VOCAB, BENCH_T))
            .build())
    rs = np.random.RandomState(2)
    ids = rs.randint(0, BENCH_VOCAB, (BENCH_BATCH, BENCH_T))
    eye = np.eye(BENCH_VOCAB, dtype=np.float32)
    x, y = eye[ids], eye[np.roll(ids, -1, 1)]
    n = 2 * RNN_K
    batches = [DataSet(x, y)] * n

    def fit(net, scan, k=n):
        net.fit(ExistingDataSetIterator(batches[:k]), scan_steps=scan)

    nets = []
    for scan in (1, RNN_K):
        nets.append(MultiLayerNetwork(conf).init())
        fit(nets[-1], scan)
    bitwise = _bitwise(nets[0].params, nets[1].params)
    net = nets[1]

    def timed(scan):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(net, scan)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    rows = {}
    for mode, scan in (("per_call", 1), ("graph", RNN_K)):
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        first_ms = timed(scan)
        walls = [timed(scan) for _ in range(CHAR_FIT_TIMED)]
        peak = torch.cuda.max_memory_allocated()
        n_prof = 2 if scan == 1 else RNN_K          # one chunk
        prof = launch_profile(lambda: fit(net, scan, n_prof), n_prof)
        sites, where = sync_sites(lambda: fit(net, scan))
        step_ms = statistics.median(walls) / n
        busy = prof.get("device_busy_ms_per_step")
        rows[mode] = {"scan_steps": scan, "first_fit_ms": first_ms,
                      "fit_wall_ms": walls, "step_ms": step_ms,
                      "chars_per_s": BENCH_BATCH * BENCH_T / (step_ms / 1e3),
                      # the profiler's own overhead widens its window;
                      # this share is against the unprofiled step
                      "idle_share_of_timed_step": "not measured"
                      if busy is None else max(0.0, 1 - busy / step_ms),
                      "peak_memory_bytes": peak,
                      "allocated_bytes_before": held,
                      "syncs_per_fit": sites, "sync_sites": where, **prof}
    # (e) the cuDNN yardstick at (d)'s shape: the two LSTM layers only
    lstm = torch.nn.LSTM(BENCH_VOCAB, BENCH_UNITS, num_layers=2,
                         batch_first=True).cuda()
    xin = torch.from_numpy(x).cuda()

    def cudnn_step():
        out, _ = lstm(xin)
        out.sum().backward()

    prof = launch_profile(lambda: [cudnn_step() for _ in range(5)], 5)
    yard = {"cudnn_lstm_fwd_bwd_ms": cuda_ms(cudnn_step),
            "cudnn_lstm_fwd_bwd_device_ms":
                prof.get("device_busy_ms_per_step", "not measured"),
            "cudnn_lstm_device_kernels": prof.get("device_kernels_per_step")}
    graph = rows["graph"]
    row = {"phase": "char_lstm_fit", "params": net.num_params(),
           "vocab": BENCH_VOCAB, "units": BENCH_UNITS, "T": BENCH_T,
           "batch": BENCH_BATCH, "dtype": "float32", "steps_per_fit": n,
           "graph_bitwise_per_call": bitwise, "score": net.score(),
           **rows, "yardstick": yard}
    row["ok"] = bool(bitwise and np.isfinite(net.score())
                     and graph["syncs_per_fit"]["dispatch"] == 0
                     and graph["syncs_per_fit"]["chunk_loss_fetch"] <= 2)
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"char-LSTM fit: {row}")
    return row


def rnn(fa, tmp):
    """Phase 8: the recurrent path, counted from zero: card against CPU,
    the char-LSTM through the train CLI and its tbptt chunk steps,
    streaming, the char-LSTM fit loop and its cuDNN yardstick. No flash
    kernel may launch: the wrappers' counts and the profiled windows'
    kernel events must read 0 of each."""
    t0 = time.perf_counter()
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    parity = rnn_parity(tmp)
    net, cli_row = rnn_cli(tmp)
    stream = rnn_stream(net)
    fit_row = char_lstm_fit()
    profiled = [cli_row["profile_of_two_chunks"],
                stream["profile_of_one_call"], fit_row["per_call"],
                fit_row["graph"]]
    launches = {k: fa.KERNEL_LAUNCHES[k] + round(sum(
        p.get("flash_kernels_per_step", {}).get(k, 0) * p.get("steps", 0)
        for p in profiled)) for k in KERNELS}
    summary = {"phase": "rnn", "gpu": gpu_line(),
               "seconds": time.perf_counter() - t0,
               "flash_launches": launches,
               "card_vs_cpu_ok": parity["ok"],
               "cli_iterations": cli_row["iterations"],
               "chunk_ms": cli_row["chunk_ms"],
               "chunk_idle_share":
                   cli_row["profile_of_two_chunks"].get("idle_share"),
               "stream_max_abs_err": stream["max_abs_err_vs_output"],
               "char_lstm_step_ms": {m: fit_row[m]["step_ms"]
                                     for m in ("per_call", "graph")},
               "char_lstm_graph_bitwise": fit_row["graph_bitwise_per_call"],
               "cudnn_yardstick": fit_row["yardstick"]}
    emit(summary)
    if any(launches.values()):
        raise AssertionError(f"flash kernels on the rnn path: {launches}")
    return {"flash_launches": launches}


# the zoo phase: YOLO2 at full width (the zoo's YOLO2(): 608², 80 classes,
# 5 anchors, a 19x19 grid, Adam(1e-3)), VGG16 at BASELINE's "ResNet-50 /
# VGG16" shape, every other new zoo model at its default input, and
# BASELINE's "LeNet MNIST" through the train CLI
YOLO_HW, YOLO_GRID, YOLO_CLASSES = 608, 19, 80
YOLO_BATCH, YOLO_CLI_IMAGES = 16, 32
YOLO_WARMUP, YOLO_TIMED, YOLO_FALL_STEPS, YOLO_SCAN_K = 3, 10, 20, 10
YOLO_PARITY = dict(num_classes=3, input_shape=(64, 64, 3))
VGG_BATCH, VGG_HW = 64, 224
ZOO_BATCH = 8
ZOO_OTHERS = ("AlexNet", "VGG19", "GoogLeNet", "Darknet19", "TinyYOLO",
              "InceptionResNetV1", "FaceNetNN4Small2", "UNet")
ZOO_INPUT = {}          # per-model overrides of the default input shape
MNIST_BATCH = 64


def forward_gflop_per_image(conf) -> float:
    """Forward GFLOP an image of the convolutions and dense layers (2 a
    multiply-add), from the shapes the configuration resolves to:
    bench.py's way of counting ResNet-50 (24.6 = 3 x 8.2 a step)."""
    from deeplearning4j_tpu_torch.nn.conf.graph_vertices import (
        GraphVertexConf,
    )
    from deeplearning4j_tpu_torch.nn.conf.network import (
        ComputationGraphConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    if isinstance(conf, ComputationGraphConfiguration):
        shapes = ComputationGraph(conf, device="cpu")   # types only
        shapes._vertex_types = shapes._resolve_types()
        pairs = [(conf.vertices[n].vertex, shapes._layer_input_type(n))
                 for n in shapes._topo
                 if not isinstance(conf.vertices[n].vertex, GraphVertexConf)]
    else:
        pairs = list(zip(conf.layers, MultiLayerNetwork(
            conf, device="cpu")._resolve_types()))
    flops = 0
    for layer, t in pairs:
        kind = type(layer).__name__
        if kind == "ConvolutionLayer":
            out = layer.output_type(t)
            kh, kw = layer.kernel
            flops += (2 * out.shape[0] * out.shape[1] * kh * kw * t.shape[2]
                      * out.shape[2])
        elif kind in ("DenseLayer", "OutputLayer"):
            flops += 2 * t.features * layer.n_out
    return flops / 1e9


def yolo_labels(rs, n, grid, classes, max_boxes=2):
    """(n, grid, grid, 4 + classes) float32: 1..max_boxes boxes an image,
    [x1, y1, x2, y2] in grid units in the cell of the box's centre, and
    the one-hot class."""
    y = np.zeros((n, grid, grid, 4 + classes), np.float32)
    for i in range(n):
        for _ in range(1 + i % max_boxes):
            cx, cy = rs.uniform(0.2, grid - 0.2, 2)
            w, h = rs.uniform(0.3, min(4.0, grid / 2), 2)
            y[i, int(cy), int(cx), :4] = [cx - w / 2, cy - h / 2,
                                         cx + w / 2, cy + h / 2]
            y[i, int(cy), int(cx), 4:] = 0
            y[i, int(cy), int(cx), 4 + rs.randint(classes)] = 1
    return y


def _tree_rel(a_tree, b_tree):
    """The worst over leaves of |a - b| (b on the CPU) over b's largest
    value."""
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    b_leaves = dict(iter_leaves(b_tree))
    worst = 0.0
    for path, a in iter_leaves(a_tree):
        b = b_leaves[path]
        err = (a.detach().cpu() - b).abs().max().item() \
            / max(b.abs().max().item(), 1e-300)
        if err != err:
            return err
        worst = max(worst, err)
    return worst


def _vae_mln(device, dtype="float64"):
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        OutputLayer, VariationalAutoencoder,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(4).updater(Adam(1e-3))
            .dtype(dtype).list()
            .layer(VariationalAutoencoder(n_out=8, encoder_layer_sizes=(32,),
                                          decoder_layer_sizes=(32,),
                                          num_samples=2))
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(20)).build())
    return MultiLayerNetwork(conf, device=device).init()


def zoo_parity(tmp):
    """Phase 9a: the card against the CPU. TinyYOLO (3 classes, 64²) from
    one zip, batch 4 with 1-2 labelled boxes an image: output() within
    1e-4 in f32 (TF32 off) and the score within rtol 1e-4; in f64 the
    training score and gradients within 1e-10 (of each leaf's largest
    gradient) and one fit step: Adam's first step is g / (|g| + 1e-8) an
    entry, which multiplies the error of entries with |g| near 1e-8 by up
    to max|g| / 1e-8, so the step is held within 1e-6 of each leaf's
    largest update and the batch norm state within 1e-10. A VAE network's
    negative ELBO with one fixed noise, and its gradients, in f64 within
    1e-10. check_gradients in f64 on the card for a Yolo2OutputLayer head
    and a VAE network."""
    import dataclasses
    import os
    from deeplearning4j_tpu_torch import gradientcheck as gc
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.models.zoo import TinyYOLO
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers import (
        ConvolutionLayer, Yolo2OutputLayer,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Sgd, tree_leaves, tree_map
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    rs = np.random.RandomState(17)
    hw = YOLO_PARITY["input_shape"][0]
    grid = hw // 32
    X = rs.rand(4, hw, hw, 3)
    Y = yolo_labels(rs, 4, grid, YOLO_PARITY["num_classes"])
    row = {"phase": "zoo_parity", "model": "TinyYOLO", **YOLO_PARITY,
           "batch": 4, "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    for dtype in ("float32", "float64"):
        conf = dataclasses.replace(TinyYOLO(**YOLO_PARITY).conf(),
                                   dtype=dtype)
        src = ComputationGraph(conf, device="cpu").init()
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():                   # BN state off its init
            for _, t in iter_leaves(src.state):
                t.add_(0.2 * torch.rand(t.shape, generator=g))
        path = save_model(src, os.path.join(tmp, f"tinyyolo_{dtype}.zip"),
                          compression=STORED)
        card, cpu = load_model(path), load_model(path, device="cpu")
        mds = MultiDataSet((X.astype(dtype),), (Y.astype(dtype),))
        if dtype == "float32":
            out = card.output(X.astype(dtype))
            row["f32_output_max_abs_err"] = (
                out.cpu() - cpu.output(X.astype(dtype))).abs().max().item()
            row["f32_output_finite"] = bool(torch.isfinite(out).all())
            sc, sp = card.score(mds), cpu.score(mds)
            row["f32_score"] = [sc, sp]
            row["f32_score_rel_err"] = abs(sc - sp) / abs(sp)
            continue
        c_loss, c_grads, _ = card.compute_gradient_and_score(mds)
        p_loss, p_grads, _ = cpu.compute_gradient_and_score(mds)
        row["f64_score_rel_err"] = abs(float(c_loss) - float(p_loss)) \
            / abs(float(p_loss))
        row["f64_grad_err_over_leaf_max"] = _tree_rel(c_grads, p_grads)
        before = dict((p, t.clone()) for p, t in iter_leaves(cpu.params))
        card.fit(mds)
        cpu.fit(mds)
        row["f64_fit_step_err_over_update"] = _leaf_errors(
            card.params, cpu.params, before)
        row["f64_bn_state_err_over_leaf_max"] = _tree_rel(card.state,
                                                          cpu.state)
    # the VAE's ELBO with one fixed noise, and its gradients
    xv = rs.randn(16, 20)
    eps = [rs.randn(16, 8) for _ in range(2)]
    vae = {}
    for device in ("cuda", "cpu"):
        net = _vae_mln(device)
        live = tree_map(lambda t: t.clone().requires_grad_(True),
                        net.params["0"])
        score = net.layers[0].pretrain_score(
            live, torch.from_numpy(xv).to(device),
            eps=[torch.from_numpy(e) for e in eps])
        grads = torch.autograd.grad(score, tree_leaves(live))
        vae[device] = (float(score.detach()), {str(i): g.cpu() for i, g in
                                      enumerate(grads)})
    row["vae_elbo"] = [vae["cuda"][0], vae["cpu"][0]]
    row["vae_elbo_rel_err"] = abs(vae["cuda"][0] - vae["cpu"][0]) \
        / abs(vae["cpu"][0])
    row["vae_grad_err_over_leaf_max"] = _tree_rel(vae["cuda"][1],
                                                  vae["cpu"][1])
    # gradient checks in f64 on the card
    head = (NeuralNetConfiguration.Builder().seed(0).updater(Sgd(1e-2))
            .list()
            .layer(ConvolutionLayer(n_out=14, kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="same"))
            .layer(Yolo2OutputLayer(anchors=((1.0, 1.0), (0.5, 0.5)),
                                    n_classes=2))
            .set_input_type(InputType.convolutional(4, 4, 3)).build())
    yh = np.zeros((2, 2, 2, 6))
    yh[0, 0, 0] = [0.1, 0.1, 0.9, 0.9, 1, 0]
    yh[1, 1, 1] = [1.2, 1.2, 1.9, 1.8, 0, 1]
    checks = {
        "yolo_head": gc.check_gradients(
            MultiLayerNetwork(head).init(), rs.rand(2, 4, 4, 3), yh,
            max_per_param=8, max_rel_error=2e-3),
        "vae": gc.check_gradients(
            _vae_mln("cuda"), rs.randn(6, 20), np.eye(3)[rs.randint(0, 3, 6)],
            max_per_param=8, max_rel_error=2e-3)}
    row["gradient_checks"] = {
        k: {"passed": r.passed, "entries": r.n_params_checked,
            "max_rel_error": r.max_rel_error} for k, r in checks.items()}
    row["ok"] = bool(
        row["f32_output_finite"] and row["f32_output_max_abs_err"] <= 1e-4
        and row["f32_score_rel_err"] <= 1e-4
        and row["f64_score_rel_err"] <= 1e-10
        and row["f64_grad_err_over_leaf_max"] <= 1e-10
        and row["f64_fit_step_err_over_update"] <= 1e-6
        and row["f64_bn_state_err_over_leaf_max"] <= 1e-10
        and row["vae_elbo_rel_err"] <= 1e-10
        and row["vae_grad_err_over_leaf_max"] <= 1e-10
        and all(r.passed and r.n_params_checked >= 16
                for r in checks.values()))
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"zoo card against CPU: {row}")
    return row


def yolo_cli(tmp):
    """Phase 9b: the entry point at full width: the zoo's YOLO2() saved
    with save_model, YOLO_CLI_IMAGES seeded images with 1-4 boxes each in
    an npz, train.cli.main(--mode single --batch-size YOLO_BATCH); then the
    reloaded zip's output() on 4 images through decode_detections and
    non_max_suppression."""
    import contextlib
    import os
    from deeplearning4j_tpu_torch.models.zoo import YOLO2
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.layers.objdetect import (
        decode_detections, non_max_suppression,
    )
    from deeplearning4j_tpu_torch.train import cli as train_cli
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    src, out = os.path.join(tmp, "yolo2.zip"), os.path.join(tmp, "o.zip")
    data = os.path.join(tmp, "boxes.npz")
    t0 = time.perf_counter()
    model = YOLO2(num_classes=YOLO_CLASSES,
                  input_shape=(YOLO_HW, YOLO_HW, 3))
    net = model.init()
    n_params = net.num_params()
    save_model(net, src, compression=STORED)
    del net
    rs = np.random.RandomState(23)
    x = rs.rand(YOLO_CLI_IMAGES, YOLO_HW, YOLO_HW, 3).astype("float32")
    np.savez(data, features=x, labels=yolo_labels(
        rs, YOLO_CLI_IMAGES, YOLO_GRID, YOLO_CLASSES, max_boxes=4))
    setup_s = time.perf_counter() - t0
    stdout = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(stdout):
        code = train_cli.main(["--model", src, "--output", out, "--dataset",
                               data, "--mode", "single", "--batch-size",
                               str(YOLO_BATCH), "--score-every", "1"])
    wall_s = time.perf_counter() - t0
    last = stdout.getvalue().strip().splitlines()[-1]
    result = json.loads(last)
    steps = YOLO_CLI_IMAGES // YOLO_BATCH
    trained = load_model(out)
    preds = trained.output(x[:4])
    boxes, kept, valid = [], [], True
    for b, s, c in decode_detections(preds, model.anchors, YOLO_CLASSES,
                                     conf_threshold=0.5):
        boxes.append(len(b))
        kept.append(len(non_max_suppression(b, s, c, 0.45)))
        valid = valid and bool(np.isfinite(b).all() and (b[:, 2] >= b[:, 0])
                               .all() and (b[:, 3] >= b[:, 1]).all()
                               and ((s >= 0.5) & (s <= 1)).all()
                               and ((c >= 0) & (c < YOLO_CLASSES)).all())
    ok = (code == 0 and set(result) == {"output", "final_score",
                                        "iterations", "epochs"}
          and result["iterations"] == steps and result["epochs"] == 1
          and np.isfinite(result["final_score"])
          and isinstance(trained, ComputationGraph)
          and trained.iteration_count == steps
          and trained.opt_state is not None
          and trained.num_params() == n_params
          and tuple(preds.shape) == (4, YOLO_GRID, YOLO_GRID,
                                     5 * (5 + YOLO_CLASSES))
          and bool(torch.isfinite(preds).all()) and valid
          and all(k <= b and (k > 0) == (b > 0)
                  for k, b in zip(kept, boxes)))
    row = {"phase": "zoo_yolo_cli", "params": n_params,
           "images": YOLO_CLI_IMAGES, "image": [YOLO_HW, YOLO_HW, 3],
           "batch": YOLO_BATCH, "setup_s": setup_s, "cli_wall_s": wall_s,
           "result": result, "decoded_boxes_per_image": boxes,
           "boxes_after_nms": kept, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError(f"train CLI on YOLO2: exit {code}, {row}")
    return row


def _yolo_batch_on_card(n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(n, YOLO_HW, YOLO_HW, 3, generator=g, device="cuda")
    y = torch.from_numpy(yolo_labels(np.random.RandomState(seed), n,
                                     YOLO_GRID, YOLO_CLASSES, 4)).cuda()
    return x, y


def _yolo2(compute_dtype=None, dtype=None):
    import dataclasses
    from deeplearning4j_tpu_torch.models.zoo import YOLO2
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = YOLO2(num_classes=YOLO_CLASSES,
                  input_shape=(YOLO_HW, YOLO_HW, 3)).conf()
    if compute_dtype is not None:
        conf = dataclasses.replace(conf, compute_dtype=compute_dtype)
    return ComputationGraph(conf).init()


def step_rate_row(name, compute_dtype, batch, gflop, step_ms, host_ms, peak):
    p50 = statistics.median(step_ms)
    dtype = compute_dtype or "float32"
    peak_rate = peak_flops(dtype)
    tflops = 3 * gflop * 1e9 * batch / (p50 / 1e3) / 1e12
    return {"phase": name, "compute_dtype": dtype, "batch": batch,
            "step_ms_p50": p50, "step_ms_max": max(step_ms),
            "step_ms": step_ms, "step_host_ms_p50": statistics.median(host_ms),
            "imgs_per_s": batch / (p50 / 1e3),
            "forward_gflop_per_image": gflop,
            "tflops_at_3x_forward": tflops, "peak_tflops": peak_rate / 1e12,
            "share_of_peak": tflops * 1e12 / peak_rate,
            "peak_memory_bytes": peak}


def yolo_timed(compute_dtype):
    """Phase 9c: the zoo's YOLO2 at 608², batch YOLO_BATCH, one seeded
    batch on the card, Adam(1e-3): per-call fit steps (YOLO_WARMUP, then
    YOLO_TIMED timed by CUDA events), imgs/s, TFLOP/s at 3x the forward
    GFLOP, host launch calls and device kernels a step, syncs a step,
    device ms by category, the loss's own time, idle share, peak memory."""
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    net = _yolo2(compute_dtype)
    gflop = forward_gflop_per_image(net.conf)
    x, y = _yolo_batch_on_card(YOLO_BATCH, 2024)
    mds = MultiDataSet((x,), (y,))
    losses, step_ms, host_ms = timed_fit_steps(net, mds, YOLO_WARMUP,
                                               YOLO_TIMED)
    peak = torch.cuda.max_memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(5)
    launches = launch_profile(
        lambda: [float(net._train_step(mds, gen)) for _ in range(2)], 2)
    phased, _ = phased_profile(net, lambda live: net._score_fn(
        live, net.state, net._as_inputs(mds.features),
        net._as_labels(mds.labels), None, None, True, gen))
    syncs = count_syncs(lambda: float(net._train_step(mds, gen)))
    # the loss alone, forward and backward, on the head's input
    head = net.conf.vertices["yolo"].vertex
    with torch.no_grad():
        acts, _, _, _ = net._forward(net._cast_params(net.params), net.state,
                                     net._as_inputs(mds.features), False,
                                     stash_pre=True)
    pre = acts["__pre__yolo"].detach().requires_grad_(True)
    labels = net._as_labels(mds.labels)[0]
    loss_ms = cuda_ms(lambda: torch.autograd.grad(
        head.score({}, pre, labels), pre), iters=10)
    row = step_rate_row("zoo_yolo_timed", compute_dtype, YOLO_BATCH, gflop,
                        step_ms, host_ms, peak)
    row.update({"params": net.num_params(), "image": [YOLO_HW, YOLO_HW, 3],
                "classes": YOLO_CLASSES, "updater": "Adam(1e-3)",
                "cudnn_benchmark": torch.backends.cudnn.benchmark,
                "host_launch_calls_per_step":
                    launches.get("host_launch_calls_per_step"),
                "device_kernels_per_step":
                    launches.get("device_kernels_per_step"),
                "device_busy_ms_per_step":
                    launches.get("device_busy_ms_per_step", "not measured"),
                "idle_share": launches.get("idle_share", "not measured"),
                "syncs_per_step": syncs, "by_category": phased,
                "loss_fwd_bwd_ms": loss_ms, "losses": losses})
    emit(row)
    del net, mds, x, y, acts, pre
    torch.cuda.empty_cache()
    return row


def yolo_graph():
    """Phase 9c, continued: YOLO2 in bf16 through the fit loop's replayed
    graph, fit(iterator, scan_steps=YOLO_SCAN_K) over one seeded batch of
    uint8 pixels with the ImagePreProcessingScaler applied on the card,
    per-call (scan_steps=1, the same pipeline) beside it: step ms, host
    launch calls, device kernels, idle share, syncs by site, peak memory.
    Then the graph's steps against per-call steps from one init, one
    chunk of YOLO_SCAN_K with cuDNN's deterministic algorithms: the
    parameters and batch norm state bitwise equal."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.normalization import (
        ImagePreProcessingScaler,
    )
    rs = np.random.RandomState(29)
    x8 = rs.randint(0, 256, (YOLO_BATCH, YOLO_HW, YOLO_HW, 3), dtype=np.uint8)
    y = yolo_labels(rs, YOLO_BATCH, YOLO_GRID, YOLO_CLASSES, 4)
    batches = [DataSet(x8, y)] * (2 * YOLO_SCAN_K)

    def make_it(n=2 * YOLO_SCAN_K):
        return ExistingDataSetIterator(batches[:n]).set_pre_processor(
            ImagePreProcessingScaler())

    net = _yolo2("bfloat16")
    rows = {}
    for mode, scan in (("per_call", 1), ("graph", YOLO_SCAN_K)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        net.fit(make_it(2 if scan == 1 else 2 * YOLO_SCAN_K),
                scan_steps=scan)                        # warm / capture
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(make_it(), scan_steps=scan)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated()
        # one chunk profiled, a whole fit's syncs counted
        n_prof = 4 if scan == 1 else YOLO_SCAN_K
        prof = launch_profile(lambda: net.fit(make_it(n_prof),
                                              scan_steps=scan), n_prof)
        n_sync = 4 if scan == 1 else 2 * YOLO_SCAN_K
        sites, where = sync_sites(lambda: net.fit(make_it(n_sync),
                                                  scan_steps=scan))
        step = statistics.median(walls) / (2 * YOLO_SCAN_K)
        rows[mode] = {"scan_steps": scan, "fit_wall_ms": walls,
                      "step_ms": step, "imgs_per_s": YOLO_BATCH / (step / 1e3),
                      "peak_memory_bytes": peak, "syncs_per_fit": sites,
                      "sync_sites": where, **prof}
    del net
    torch.cuda.empty_cache()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        nets = []
        for scan in (1, YOLO_SCAN_K):
            net = _yolo2("bfloat16")
            net.fit(make_it(YOLO_SCAN_K), scan_steps=scan)
            nets.append(net)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    bitwise = _bitwise(nets[0].params, nets[1].params) \
        and _bitwise(nets[0].state, nets[1].state)
    scores = [n.score() for n in nets]
    del nets
    torch.cuda.empty_cache()
    graph = rows["graph"]
    row = {"phase": "zoo_yolo_graph", "compute_dtype": "bfloat16",
           "batch": YOLO_BATCH, "image": [YOLO_HW, YOLO_HW, 3],
           "chunks_per_fit": 2, **rows,
           "graph_bitwise_per_call": bitwise,
           "bitwise_check": {"steps": YOLO_SCAN_K, "image": YOLO_HW,
                             "scores": scores},
           "ok": bool(bitwise and graph["syncs_per_fit"]["dispatch"] == 0
                      and np.isfinite(scores).all())}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"YOLO2 graph fit: {row}")
    return row


def yolo_loss_fall():
    """The f32 loss over YOLO_FALL_STEPS per-call steps on yolo_timed's one
    seeded batch, with cuDNN's deterministic algorithms (a trajectory that
    repeats from run to run)."""
    from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
    net = _yolo2()
    x, y = _yolo_batch_on_card(YOLO_BATCH, 2024)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    losses = []
    try:
        for _ in range(YOLO_FALL_STEPS):
            net.fit(MultiDataSet((x,), (y,)))
            losses.append(net.score())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    del net
    torch.cuda.empty_cache()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"YOLO2 f32 loss over {YOLO_FALL_STEPS} "
                             f"deterministic steps: {losses}")
    return losses


def vgg16_timed(compute_dtype):
    """Phase 9d: the zoo's VGG16 (a MultiLayerNetwork, Nesterovs, dropout
    0.5) at 224², batch VGG_BATCH, one seeded batch on the card: per-call
    fit steps timed by CUDA events, imgs/s, TFLOP/s at 3x the forward
    GFLOP, device ms by category, peak memory. The losses are reported;
    only the first must be finite."""
    import dataclasses
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo import VGG16
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = VGG16(input_shape=(VGG_HW, VGG_HW, 3)).conf()
    if compute_dtype is not None:
        conf = dataclasses.replace(conf, compute_dtype=compute_dtype)
    net = MultiLayerNetwork(conf).init()
    g = torch.Generator(device="cuda").manual_seed(31)
    x = torch.rand(VGG_BATCH, VGG_HW, VGG_HW, 3, generator=g, device="cuda")
    y = torch.nn.functional.one_hot(
        torch.randint(0, 1000, (VGG_BATCH,), generator=g, device="cuda"),
        1000).float()
    ds = DataSet(x, y)
    losses, step_ms, host_ms = timed_fit_steps(net, ds, 3, 10)
    peak = torch.cuda.max_memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(5)
    launches = launch_profile(
        lambda: [float(net._train_step(ds, gen)) for _ in range(2)], 2)
    phased, _ = phased_profile(net, lambda live: net._score_fn(
        live, net.state, net._stage_x(ds.features), net._as_labels(ds.labels),
        None, None, True, gen))
    row = step_rate_row("zoo_vgg16_timed", compute_dtype, VGG_BATCH,
                        forward_gflop_per_image(conf), step_ms, host_ms, peak)
    row.update({"params": net.num_params(), "image": [VGG_HW, VGG_HW, 3],
                "classes": 1000, "updater": "Nesterovs(1e-2, 0.9)",
                "host_launch_calls_per_step":
                    launches.get("host_launch_calls_per_step"),
                "device_busy_ms_per_step":
                    launches.get("device_busy_ms_per_step", "not measured"),
                "idle_share": launches.get("idle_share", "not measured"),
                "by_category": phased, "losses": losses})
    emit(row)
    # Nesterovs(1e-2, 0.9) with no batch norm, on one repeated batch,
    # may diverge within the 13 steps: only the first loss is held
    if not np.isfinite(losses[0]):
        raise AssertionError(f"VGG16 {compute_dtype}: losses {losses}")
    del net, ds, x, y
    torch.cuda.empty_cache()
    return row


def zoo_others():
    """Phase 9e: every other new zoo model at its default input shape,
    batch ZOO_BATCH: one fit step on the card with a finite score, a
    second timed by CUDA events, and output() of the shape the
    configuration's output type gives."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    rows = {}
    rs = np.random.RandomState(37)
    for name in ZOO_OTHERS:
        model = model_by_name(name, **ZOO_INPUT.get(name, {}))
        net = model.init()
        h, w, _ = model.input_shape
        x = rs.rand(ZOO_BATCH, h, w, 3).astype("float32")
        if name == "TinyYOLO":
            y = yolo_labels(rs, ZOO_BATCH, h // 32, model.num_classes)
        elif name == "UNet":
            y = (rs.rand(ZOO_BATCH, h, w, model.num_classes) > 0.5).astype(
                "float32")
        else:
            y = np.eye(model.num_classes, dtype="float32")[
                rs.randint(0, model.num_classes, ZOO_BATCH)]
        graph = isinstance(net, ComputationGraph)
        batch = MultiDataSet((x,), (y,)) if graph else DataSet(x, y)
        want = (net._vertex_types[net.conf.network_outputs[0]] if graph
                else net._output_type).shape
        step_ms = []
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            net.fit(batch)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        out = net.output(x)
        rows[name] = {"input": [h, w, 3], "params": net.num_params(),
                      "forward_gflop_per_image":
                          forward_gflop_per_image(net.conf),
                      "first_step_ms": step_ms[0], "step_ms": step_ms[1],
                      "score": net.score(), "output_shape": list(out.shape),
                      "ok": bool(np.isfinite(net.score())
                                 and tuple(out.shape[1:]) == tuple(want)
                                 and torch.isfinite(out).all())}
        del net, out
        torch.cuda.empty_cache()
    row = {"phase": "zoo_models", "batch": ZOO_BATCH, "models": rows,
           "ok": all(r["ok"] for r in rows.values())}
    emit(row)
    if not row["ok"]:
        raise AssertionError(f"zoo models: {row}")
    return row


def lenet_mnist(tmp):
    """Phase 9f: BASELINE's "LeNet MNIST": the zoo's LeNet saved with
    save_model and trained by train.cli.main(--dataset mnist
    --synthetic-data --mode single --batch-size MNIST_BATCH) on the card
    (an empty dataset cache: the fetcher's seeded substitute, 2048
    images); then an AutoEncoder -> VAE -> OutputLayer network on the
    flattened synthetic MNIST runs fit_pretrain, then fit. The VAE's
    negative ELBO on one batch with one fixed noise, on the features the
    pretrained AutoEncoder gives, must be lower with the pretrained VAE
    than with its initial parameters."""
    import contextlib
    import os
    from deeplearning4j_tpu_torch.data.fetchers import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import LeNet
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers import (
        AutoEncoder, OutputLayer, VariationalAutoencoder,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Adam, tree_map
    from deeplearning4j_tpu_torch.train import cli as train_cli
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    cache = os.path.join(tmp, "datasets")
    os.makedirs(cache)
    saved_env = os.environ.get("DL4J_CUDA_DATA_DIR")
    os.environ["DL4J_CUDA_DATA_DIR"] = cache
    try:
        src, out = os.path.join(tmp, "lenet.zip"), os.path.join(tmp, "l.zip")
        save_model(LeNet().init(), src)
        stdout = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(stdout):
            code = train_cli.main(["--model", src, "--output", out,
                                   "--dataset", "mnist", "--synthetic-data",
                                   "--mode", "single", "--batch-size",
                                   str(MNIST_BATCH), "--score-every", "8"])
        wall_s = time.perf_counter() - t0
        result = json.loads(stdout.getvalue().strip().splitlines()[-1])
        it = MnistDataSetIterator(batch_size=128, synthetic=True,
                                  flatten=True)
    finally:
        if saved_env is None:
            del os.environ["DL4J_CUDA_DATA_DIR"]
        else:
            os.environ["DL4J_CUDA_DATA_DIR"] = saved_env
    steps = 2048 // MNIST_BATCH
    cli_ok = (code == 0 and result["iterations"] == steps
              and np.isfinite(result["final_score"])
              and load_model(out).iteration_count == steps)
    conf = (NeuralNetConfiguration.Builder().seed(12).updater(Adam(1e-3))
            .list()
            .layer(AutoEncoder(n_out=256, corruption_level=0.3))
            .layer(VariationalAutoencoder(
                n_out=32, encoder_layer_sizes=(128,),
                decoder_layer_sizes=(128,),
                reconstruction_distribution="bernoulli"))
            .layer(OutputLayer(n_out=10, activation="softmax",
                               loss="mcxent"))
            .set_input_type(InputType.feed_forward(784)).build())
    net = MultiLayerNetwork(conf).init()
    vae_init = tree_map(torch.clone, net.params["1"])
    t0 = time.perf_counter()
    net.fit_pretrain(it, epochs=2)
    pretrain_s = time.perf_counter() - t0
    pretrain_score = net.score()
    first = next(iter(it))
    it.reset()
    with torch.no_grad():
        feats, _, _ = net._forward(net.params, net.state,
                                   net._as_input(first.features), False,
                                   upto=1)
        eps = [torch.randn(feats.shape[0], 32, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(41))]
        vae = net.layers[1]
        elbo = [float(vae.pretrain_score(p, feats, eps=eps))
                for p in (vae_init, net.params["1"])]
    net.fit(it, epochs=1)
    fine_score = net.score()
    accuracy = net.evaluate(it).accuracy()
    ok = bool(cli_ok and elbo[1] < elbo[0] and np.isfinite(pretrain_score)
              and np.isfinite(fine_score))
    row = {"phase": "zoo_lenet_mnist", "cli_result": result,
           "cli_wall_s": wall_s, "cli_steps": steps,
           "pretrain_s": pretrain_s, "pretrain_last_score": pretrain_score,
           "vae_neg_elbo_init_vs_pretrained": elbo,
           "fine_tune_score": fine_score, "accuracy_after_one_epoch":
               accuracy, "ok": ok}
    emit(row)
    if not ok:
        raise AssertionError(f"LeNet MNIST / fit_pretrain: {row}")
    return row


def zoo(fa, tmp):
    """Phase 9: detection, the VAE and the rest of the zoo, counted from
    zero: card against CPU, YOLO2 through the train CLI, YOLO2 timed
    (f32, bf16, the replayed graph) with its loss falling, VGG16 timed,
    the other new models one step each, LeNet MNIST and layerwise
    pretraining. No flash kernel may launch: the wrappers' counts and the
    profiled windows' kernel events must read 0 of each."""
    t0 = time.perf_counter()
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    parity = zoo_parity(tmp)
    cli_row = yolo_cli(tmp)
    timed = {"float32": yolo_timed(None), "bfloat16": yolo_timed("bfloat16")}
    graph = yolo_graph()
    falling = yolo_loss_fall()
    vgg = {"float32": vgg16_timed(None), "bfloat16": vgg16_timed("bfloat16")}
    others = zoo_others()
    mnist = lenet_mnist(tmp)
    profiled = [graph["per_call"], graph["graph"]]
    launches = {k: fa.KERNEL_LAUNCHES[k] + round(sum(
        p.get("flash_kernels_per_step", {}).get(k, 0) * p.get("steps", 0)
        for p in profiled)) for k in KERNELS}
    summary = {"phase": "zoo", "gpu": gpu_line(),
               "seconds": time.perf_counter() - t0,
               "flash_launches": launches, "card_vs_cpu_ok": parity["ok"],
               "yolo_cli_iterations": cli_row["result"]["iterations"],
               "yolo_boxes_after_nms": cli_row["boxes_after_nms"],
               "yolo_first_loss_f32": falling[0],
               "yolo_last_loss_f32": falling[-1],
               "yolo_losses_f32_deterministic": falling,
               **{f"yolo2_{d}_{k}": timed[d][k] for d in timed
                  for k in ("step_ms_p50", "imgs_per_s",
                            "tflops_at_3x_forward", "idle_share",
                            "peak_memory_bytes")},
               "yolo2_bf16_graph_step_ms": graph["graph"]["step_ms"],
               "yolo2_bf16_per_call_fit_step_ms":
                   graph["per_call"]["step_ms"],
               "yolo2_graph_bitwise_per_call":
                   graph["graph_bitwise_per_call"],
               **{f"vgg16_{d}_{k}": vgg[d][k] for d in vgg
                  for k in ("step_ms_p50", "imgs_per_s",
                            "tflops_at_3x_forward", "peak_memory_bytes")},
               "other_models_step_ms": {n: r["step_ms"] for n, r in
                                        others["models"].items()},
               "lenet_mnist_cli": mnist["cli_result"],
               "vae_neg_elbo_init_vs_pretrained":
                   mnist["vae_neg_elbo_init_vs_pretrained"]}
    emit(summary)
    if any(launches.values()):
        raise AssertionError(f"flash kernels on the zoo path: {launches}")
    return {"flash_launches": launches}


# ---------------------------------------------------------------- lm_ops
LMOPS_STREAMS, LMOPS_NEW = 4, 64          # (a) greedy streams during a swap
SPEC_LENGTHS = (17, 100, 700)             # (c) greedy prompts, 64 new tokens
SPILL_POOL_PAGES, SPILL_PAGES = 129, 128  # (d) one max-context sequence
SPILL_FILL = 2032                         # (d) 127 pages: evicts the prefix
PREFIX_TOKENS = 1024                      # (d)/(e) the shared prefix


def post_json(url, payload, timeout=600):
    """POST a JSON body; (status, parsed JSON answer) — a non-2xx answer
    is returned too, with its error document."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def post_bytes(url, body, ctype, timeout=600):
    """POST raw bytes; (status, answer bytes, ms)."""
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, out = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, out = e.code, e.read()
    return status, out, (time.perf_counter() - t0) * 1e3


def itl_ms(results):
    return [1e3 * (b - a) for o in results
            for a, b in zip(o["times"], o["times"][1:])]


def concurrent_streams(url, name, specs):
    """Run `specs` ([(prompt, max_tokens, extra payload)]) as concurrent
    SSE streams; returns (results in order, wall seconds)."""
    out, errors = [None] * len(specs), []

    def one(j, prompt, n, extra):
        try:
            payload = dict(prompt=prompt, max_tokens=n, stream=True, **extra)
            res = post_generate(url, name, payload)
            check_generation(res, payload, name)
            out[j] = res
        except Exception as e:      # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(j,) + tuple(spec))
               for j, spec in enumerate(specs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    if errors or any(o is None for o in out):
        raise AssertionError(f"{name}: concurrent streams failed: {errors}")
    return out, time.perf_counter() - t0


def lmops_swap(fa, url, registry, tmp, rs):
    """(a) Rolling swap under traffic on `gen`, then rollback, a refused
    vocab-512 swap, and the predict servable `lm`'s swap and rollback."""
    from deeplearning4j_tpu_torch.serving.registry import load_servable
    from deeplearning4j_tpu_torch.util.serialization import save_model
    gen, lm = registry.get("gen"), registry.get("lm")
    v1_net = gen.model
    zip2 = f"{tmp}/lm_seed99.zip"
    save_model(load_servable(LM_SOURCE + "&seed=99"), zip2)
    prompts = [rs.randint(0, VOCAB, n).tolist() for n in (17, 60, 100, 33)]
    box = {}

    def streams():
        box["streams"] = concurrent_streams(
            url, "gen", [(p, LMOPS_NEW, {}) for p in prompts])

    torch.cuda.reset_peak_memory_stats()
    steps0 = gen.scheduler.admitting_engine().steps
    th = threading.Thread(target=streams)
    th.start()
    deadline = time.monotonic() + 300
    while gen.scheduler.admitting_engine().steps < steps0 + 2 \
            and time.monotonic() < deadline:
        time.sleep(0.001)
    t_swap = time.perf_counter()
    status, doc = post_json(f"{url}/v1/models/gen/swap", {"source": zip2})
    t_swap_end = time.perf_counter()
    th.join(timeout=900)
    if status != 200 or doc["active"]["version"] != 2:
        raise AssertionError(f"gen swap answered {status}: {doc}")
    gen_swap_s = doc["seconds"]
    swapped = gen.scheduler.admitting_engine().describe_graphs()
    peak_two_versions = torch.cuda.max_memory_allocated()
    results, _ = box["streams"]
    v2_net = gen.model
    checked = near = 0
    versions = []
    for prompt, res in zip(prompts, results):
        versions.append(res["version"])
        net = v1_net if res["version"] == 1 else v2_net
        c, t = oracle_check(net, prompt, res["tokens"])
        checked, near = checked + c, near + t
    during = [1e3 * (b - a) for o in results
              for a, b in zip(o["times"], o["times"][1:])
              if t_swap <= a and b <= t_swap_end]
    after = post_generate(url, "gen", {"prompt": prompts[0],
                                       "max_tokens": 16, "stream": False})
    if after["version"] != 2:
        raise AssertionError(f"after the swap: version {after['version']}")
    c, t = oracle_check(v2_net, prompts[0], after["tokens"])
    checked, near = checked + c, near + t
    status, doc = post_json(f"{url}/v1/models/gen/rollback", {})
    if status != 200 or doc["active"]["version"] != 1:
        raise AssertionError(f"gen rollback answered {status}: {doc}")
    rollback_s = doc["seconds"]
    back = post_generate(url, "gen", {"prompt": prompts[0],
                                      "max_tokens": 16, "stream": False})
    if back["version"] != 1:
        raise AssertionError(f"after rollback: version {back['version']}")
    c, t = oracle_check(v1_net, prompts[0], back["tokens"])
    checked, near = checked + c, near + t
    # another vocabulary: refused with a 4xx, gen keeps answering
    vocab_status, doc = post_json(f"{url}/v1/models/gen/swap", {
        "source": LM_SOURCE.replace(f"vocab_size={VOCAB}",
                                    "vocab_size=512")})
    if not 400 <= vocab_status < 500:
        raise AssertionError(f"vocab-512 swap answered {vocab_status}")
    still = post_generate(url, "gen", {"prompt": prompts[1],
                                       "max_tokens": 8, "stream": False})
    if still["version"] != 1 or len(still["tokens"]) != 8:
        raise AssertionError("gen stopped answering after a refused swap")
    # the predict servable: swap and rollback, answers follow the network
    x = rs.randint(0, VOCAB, (1, SEQ, 1)).astype("float32")
    purl = f"{url}/v1/models/lm/predict"
    l0, d0 = fa.KERNEL_LAUNCHES["flash_fwd"], lm.batcher.dispatches
    b0 = fa.KERNEL_LAUNCHES["flash_bwd_dq"] + \
        fa.KERNEL_LAUNCHES["flash_bwd_dkv"]
    status, y1, _ = post_npy(purl, x)
    check_answer(status, y1, 1)
    status, doc = post_json(f"{url}/v1/models/lm/swap", {"source": zip2})
    if status != 200 or doc["active"]["version"] != 2:
        raise AssertionError(f"lm swap answered {status}: {doc}")
    predict_swap_s = doc["seconds"]
    status, y2, _ = post_npy(purl, x)
    check_answer(status, y2, 1)
    status, doc = post_json(f"{url}/v1/models/lm/rollback", {})
    if status != 200 or doc["active"]["version"] != 1:
        raise AssertionError(f"lm rollback answered {status}: {doc}")
    status, y3, _ = post_npy(purl, x)
    check_answer(status, y3, 1)
    launches = fa.KERNEL_LAUNCHES["flash_fwd"] - l0
    dispatches = lm.batcher.dispatches - d0
    if launches != N_LAYERS * dispatches or dispatches < 3 + 2 * 2:
        raise AssertionError(f"predict swap: {launches} flash launches for "
                             f"{dispatches} dispatches")
    if fa.KERNEL_LAUNCHES["flash_bwd_dq"] + \
            fa.KERNEL_LAUNCHES["flash_bwd_dkv"] != b0:
        raise AssertionError("the swap path launched a backward kernel")
    ref2 = load_servable(zip2).output(x).float().cpu().numpy()
    err2 = float(np.abs(y2 - ref2).max())
    if not (err2 <= 1e-5 and np.array_equal(y3, y1)
            and float(np.abs(y2 - y1).max()) > 1e-3):
        raise AssertionError(f"predict answers do not follow the swaps "
                             f"(v2 err {err2})")
    return {"gen_swap_s": gen_swap_s,
            "gen_swap_capture_s": swapped["capture_s"],
            "gen_swap_graph_pool_bytes": swapped["pool_bytes"],
            "gen_swap_post_s": t_swap_end - t_swap,
            "gen_rollback_s": rollback_s,
            "stream_versions": versions, "all_200": True,
            "oracle_tokens": checked, "oracle_near_ties": near,
            "itl_ms_p50_during_swap": statistics.median(during)
            if during else None,
            "itl_ms_max_during_swap": max(during) if during else None,
            "itl_ms_p50_streams": statistics.median(itl_ms(results)),
            "peak_memory_bytes_two_versions": peak_two_versions,
            "vocab512_swap_status": vocab_status,
            "predict_swap_s": predict_swap_s,
            "predict_flash_launches": launches,
            "predict_dispatches": dispatches,
            "predict_v2_max_abs_err": err2}


def lmops_manifest(tmp):
    """(b) The port's CheckpointManager writes two checkpoints of a small
    LM; the newest is corrupted; the registry serves the older one."""
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.train.resilience import CheckpointManager
    kw = dict(vocab_size=64, seq_length=64, n_layers=2, n_embd=64,
              n_heads=2, attention_impl="flash")
    nets = [model_by_name("TransformerLM", seed=s, **kw).init()
            for s in (1, 2)]
    ckdir = f"{tmp}/ckpts"
    mgr = CheckpointManager(ckdir)
    paths = [mgr.save(n, {"step_in_epoch": i}) for i, n in enumerate(nets)]
    with open(paths[1], "r+b") as f:
        f.seek(20)
        f.write(b"\xde\xad\xbe\xef")
    registry = ModelRegistry()
    try:
        served = registry.deploy("ck", ckdir, buckets=(1,))
        x = np.random.RandomState(8).randint(0, 64, (1, 64, 1)) \
            .astype("float32")
        y = served.predict(x)
        errs = [float(np.abs(y - n.output(x).float().cpu().numpy()).max())
                for n in nets]
    finally:
        registry.shutdown(drain=False)
    if not (errs[0] <= 1e-5 and errs[1] > 1e-3):
        raise AssertionError(f"manifest directory served the wrong entry: "
                             f"{errs}")
    return {"served_entry": mgr.latest_valid()["file"],
            "max_abs_err_vs_older": errs[0],
            "max_abs_err_vs_corrupt_newest": errs[1]}


def verify_bitwise_on_card(net, k=4):
    """Engine level: one k-drafted verify against k+1 sequential steps of
    an identical engine state, four live slots, bitwise."""
    from deeplearning4j_tpu_torch.serving.decode import (
        DecodeConfig, DecodeEngine,
    )
    cfg = DecodeConfig(slots=4, page_size=16)
    a, b = (DecodeEngine(net, cfg, name=n) for n in ("seq", "verify"))
    rs = np.random.RandomState(17)
    try:
        slots = []
        for n in SPEC_LENGTHS + (31,):
            p = rs.randint(0, VOCAB, n)
            sa, sb = a.cache.admit(n), b.cache.admit(n)
            if sa != sb or a.prefill(sa, p, 0.0, 0)[0] \
                    != b.prefill(sb, p, 0.0, 0)[0]:
                raise AssertionError("verify check: prefills differ")
            slots.append(sa)
        seq, toks = [], []
        for _ in range(k + 1):
            tk, _, lg = a.step()
            seq.append(lg.clone())
            toks.append(tk.copy())
        act = np.zeros((4,), bool)
        drafted = np.zeros((4, k), np.int64)
        for s in slots:
            if not b.cache.ensure_capacity(s, k + 1):
                raise AssertionError("verify check: no pages")
            act[s] = True
            drafted[s] = [toks[i][s] for i in range(k)]
        with torch.no_grad():
            vlog = b._verify(b._last_tokens, act,
                             torch.from_numpy(drafted).cuda(),
                             np.arange(4, dtype=np.int64))
        same = all(torch.equal(vlog[s, i], seq[i][s])
                   for s in slots for i in range(k + 1))
    finally:
        a.close()
        b.close()
    if not same:
        raise AssertionError("verify logits are not bitwise the sequential "
                             "steps")
    return {"slots": len(slots), "positions": k + 1, "bitwise": True}


def profile_spec_rounds(engine, rounds=3):
    """torch.profiler over `rounds` speculative rounds with live slots:
    kernel launches per round and device busy ms, and the rounds' host
    syncs by CUDA's sync debug mode."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(rounds):
            engine.spec_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in profiler_events(prof)
              if e.device_type == DeviceType.CUDA]
    copies = [e for e in events if "memcpy" in e.name.lower()
              or "memset" in e.name.lower()]
    busy = sum(e.us for e in events) / 1e3
    syncs = count_syncs(engine.spec_step)
    split = spec_round_split(engine)
    return {"rounds": rounds, "round_ms": wall_ms / rounds, **split,
            "kernel_launches_per_round": (len(events) - len(copies))
            / rounds if events else "not measured",
            "device_busy_ms_per_round": busy / rounds if events
            else "not measured",
            "idle_share": max(0.0, 1.0 - busy / wall_ms) if events
            else "not measured",
            "host_syncs_one_round": syncs}


def spec_round_split(engine, rounds=16):
    """`rounds` speculative rounds on `engine`'s live slots, each split
    into the draft's propose and the target's verify (CUDA events around
    each: the operands' copy and the graph's replay, device ms), the
    round's wall ms by the host's clock (its one sync included), and the
    host ms left (wall minus both); plus graph replays a round."""
    d = engine.draft
    marks = []

    def timed(fn, key):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            marks.append((key, start, end))
            return out
        return run

    d._propose = timed(d._propose, "draft")
    engine._verify = timed(engine._verify, "verify")
    replays0 = engine.graph_stats["replays"] + d.graph_stats["replays"]
    try:
        walls, events, parts = [], [], {"draft": [], "verify": []}
        for _ in range(rounds):
            marks.clear()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            engine.spec_step()
            end.record()
            walls.append((time.perf_counter() - t0) * 1e3)
            end.synchronize()
            events.append(start.elapsed_time(end))
            for key, a, b in marks:
                parts[key].append(a.elapsed_time(b))
    finally:
        del d._propose, engine._verify
    replays = (engine.graph_stats["replays"] + d.graph_stats["replays"]
               - replays0) / rounds
    draft, verify = (statistics.median(parts[k]) for k in ("draft",
                                                           "verify"))
    wall = statistics.median(walls)
    return {"round_wall_ms_p50": wall,
            "round_event_ms_p50": statistics.median(events),
            "draft_replay_ms_p50": draft,
            "verify_replay_ms_p50": verify,
            "round_host_ms_p50": wall - draft - verify,
            "graph_replays_per_round": replays}


def lmops_c8(rs):
    """(f) Fault C.8 on the card: the decode smoke's speculative A/B
    (`tools/decode_smoke.spec_ab`: its arch, 2 slots,
    @spec:draft=int8,k=12, 52 greedy streams of 120 tokens after two
    throwaway streams an arm), then the spec engine's round split and the
    plain engine's step ms over two live slots, engine level."""
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.tools import decode_smoke
    registry = ModelRegistry(device="cuda")
    t0 = time.perf_counter()
    try:
        ab, failures = decode_smoke.spec_ab(registry)
        ab_s = time.perf_counter() - t0
        if ab["mismatched_streams"] or ab["acceptance_rate"] <= 0.5:
            raise AssertionError(f"C.8 A/B: {failures}")
        spec = registry.get("lm_spec").scheduler.admitting_engine()
        base = registry.get("lm_spec_base").scheduler.admitting_engine()
        slots = []
        try:
            for e in (spec, base):
                for _ in range(2):
                    p = rs.randint(0, 32, 8)
                    info = e.admit_prompt(p)
                    slots.append((e, info.slot))
                    e.prefill(info.slot, p, 0.0, 0)
                    if e is spec:
                        e.draft.prefill(e._draft_slots[info.slot], p, 0.0, 0)
            split = spec_round_split(spec, rounds=12)
            step_ms = []
            for _ in range(16):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t1 = time.perf_counter()
                start.record()
                base.step()
                end.record()
                end.synchronize()
                step_ms.append(((time.perf_counter() - t1) * 1e3,
                                start.elapsed_time(end)))
        finally:
            for e, slot in slots:
                e.release_slot(slot)
        first_runs = {n: registry.get(n).scheduler.admitting_engine()
                      .request_path_first_runs
                      for n in ("lm_spec", "lm_spec_base")}
        if any(first_runs.values()):
            raise AssertionError(f"C.8 A/B first runs: {first_runs}")
    finally:
        registry.shutdown(drain=False)
    return {"arch": decode_smoke.SPEC_ARCH, "k": 12, "slots": 2, **ab,
            "spec_over_plain": ab["itl_p99_ms"] / ab["base_itl_p99_ms"],
            "gate_spec_below_plain": "not gated",
            "smoke_failures": failures, "seconds": ab_s,
            "round_split": split,
            "plain_step_wall_ms_p50": statistics.median(
                w for w, _ in step_ms),
            "plain_step_event_ms_p50": statistics.median(
                d for _, d in step_ms),
            "request_path_first_runs": first_runs}


def lmops_spec(url, registry, rs):
    """(c) Greedy speculative streams bitwise gen's, one sampled stream in
    the target's top 5, the verify bitwise on the card, and the rates
    beside plain decode in the same run."""
    gen, spec = registry.get("gen"), registry.get("spec")
    eng = spec.scheduler.admitting_engine()
    prompts = [rs.randint(0, VOCAB, n).tolist() for n in SPEC_LENGTHS]
    mismatched = []
    for p in prompts:
        a = post_generate(url, "gen", {"prompt": p, "max_tokens": LMOPS_NEW,
                                       "stream": False})
        b = post_generate(url, "spec", {"prompt": p, "max_tokens": LMOPS_NEW,
                                        "stream": False})
        if a["tokens"] != b["tokens"]:
            mismatched.append(len(p))
    if mismatched:
        raise AssertionError(f"speculative greedy tokens differ from gen's "
                             f"at prompt lengths {mismatched}")
    sp = prompts[0]
    sampled = post_generate(url, "spec", {"prompt": sp, "max_tokens": 32,
                                          "temperature": 1.0, "top_k": 5,
                                          "stream": False})
    topk_checked, topk_near = oracle_check(spec.model, sp,
                                           sampled["tokens"], top=5)
    # rates: the same four concurrent greedy streams on each servable
    conc = [(p, LMOPS_NEW, {}) for p in
            [rs.randint(0, VOCAB, n).tolist() for n in (17, 100, 40, 60)]]
    rates = {}
    stats0 = dict(eng.spec_stats)
    for name in ("gen", "spec"):
        res, wall = concurrent_streams(url, name, conc)
        rates[name] = {"tokens_per_s": sum(len(o["tokens"]) for o in res)
                       / wall,
                       "itl_ms_p50": statistics.median(itl_ms(res)),
                       "itl_ms_max": max(itl_ms(res)), "wall_s": wall}
        if name == "spec":
            rates[name]["spec_proposed"] = sum(o["spec_proposed"]
                                               for o in res)
            rates[name]["spec_accepted"] = sum(o["spec_accepted"]
                                               for o in res)
            rates[name]["spec_rounds_per_stream"] = [o["spec_rounds"]
                                                     for o in res]
    if rates["spec"]["spec_proposed"] == 0:
        raise AssertionError("no speculative round ran")
    st = eng.spec_stats
    syncs_per_round = (st["host_syncs"] - stats0["host_syncs"]) \
        / max(1, st["rounds"] - stats0["rounds"])
    # a profiled window of rounds with four live slots (engine level)
    slots = []
    try:
        for n in SPEC_LENGTHS + (31,):
            p = rs.randint(0, VOCAB, n)
            info = eng.admit_prompt(p)
            slots.append(info.slot)
            eng.prefill(info.slot, p, 0.0, 0)
            ds = eng._draft_slots[info.slot]
            eng.draft.prefill(ds, p, 0.0, 0)
        prof = profile_spec_rounds(eng)
    finally:
        for s in slots:
            eng.release_slot(s)
    if prof["host_syncs_one_round"] > 1 or syncs_per_round > 1:
        raise AssertionError(f"host syncs per speculative round: "
                             f"{prof['host_syncs_one_round']}")
    first_runs = {"gen": gen.scheduler.admitting_engine()
                  .request_path_first_runs,
                  "spec": eng.request_path_first_runs,
                  "spec.draft": eng.draft.request_path_first_runs}
    if any(first_runs.values()):
        raise AssertionError(f"programs first ran on the request path: "
                             f"{first_runs}")
    return {"greedy_bitwise_gen_prompt_lens": list(SPEC_LENGTHS),
            "sampled_topk_tokens": topk_checked,
            "sampled_topk_near_ties": topk_near,
            "verify_bitwise": verify_bitwise_on_card(gen.model),
            "acceptance_rate": st["accepted"] / max(1, st["proposed"]),
            "rounds": st["rounds"], "proposed": st["proposed"],
            "accepted": st["accepted"], "fallbacks": st["fallbacks"],
            "host_syncs_per_round": syncs_per_round,
            "round_profile": prof, "rates": rates,
            "graphs": graph_report({
                "gen": gen.scheduler.admitting_engine(), "spec": eng}),
            "request_path_first_runs": first_runs}


def lmops_spill(gen_url, tmp, rs):
    """(d) A pool of one max-context sequence (128 pages) and a 128-page
    host tier: a 1024-token prompt's 64 pages demote when a 2032-token
    prompt (127 pages + its new tokens) needs the pool, and promote back
    on its repeat, with gen's tokens."""
    from deeplearning4j_tpu_torch.serving import cli
    args = cli.build_parser().parse_args(
        ["--lm", f"spill={LM_SOURCE}", "--decode-slots", "4",
         "--decode-page-size", "16", "--decode-pool-pages",
         str(SPILL_POOL_PAGES), "--kv-spill-pages", str(SPILL_PAGES),
         "--port", "0"])
    registry, server = cli.build(args)
    try:
        eng = registry.get("spill").scheduler.admitting_engine()
        a = rs.randint(0, VOCAB, PREFIX_TOKENS).tolist()
        fills = [rs.randint(0, VOCAB, SPILL_FILL).tolist()]
        first = post_generate(server.url, "spill", {
            "prompt": a, "max_tokens": 16, "stream": False})
        for f in fills:
            post_generate(server.url, "spill", {"prompt": f, "max_tokens": 16,
                                                "stream": False})
        demoted = eng.fabric["demoted"]
        if demoted == 0:
            raise AssertionError("no page demoted to the spill tier")
        prom0 = eng.cache.spill_stats["promotions"]
        again = post_generate(server.url, "spill", {
            "prompt": a, "max_tokens": 16, "stream": False})
        promoted = eng.cache.spill_stats["promotions"] - prom0
        if promoted == 0 or again["cached_tokens"] < PREFIX_TOKENS - 16:
            raise AssertionError(f"repeat: {promoted} promotions, "
                                 f"{again['cached_tokens']} cached tokens")
        plain = post_generate(gen_url, "gen", {"prompt": a, "max_tokens": 16,
                                               "stream": False})
        if not (again["tokens"] == first["tokens"] == plain["tokens"]):
            raise AssertionError("spilled prefix changed the tokens")
        fab = dict(eng.fabric)
        return {"pool_pages": SPILL_POOL_PAGES, "spill_pages": SPILL_PAGES,
                "demoted": fab["demoted"], "promoted_on_repeat": promoted,
                "cached_tokens_on_repeat": again["cached_tokens"],
                "ms_per_page_demoted": 1e3 * fab["demote_s"]
                / max(1, fab["demoted"]),
                "ms_per_page_promoted_host": 1e3 * fab["land_s"]
                / max(1, fab["landed"]),
                "frame_bytes": eng.spill.frame_bytes,
                "slab_bytes": eng.spill.pages * eng.spill.slot_bytes,
                "spill": eng.cache.describe()["spill"],
                "tokens_equal_no_spill": True}
    finally:
        server.drain(timeout=30)


def lmops_disagg(rs):
    """(e) A prefill server and a decode server from cli.build(): the
    1024-token prefix exported from one and imported into the other."""
    from deeplearning4j_tpu_torch.serving import cli
    servers = []
    try:
        for role in ("prefill", "decode"):
            args = cli.build_parser().parse_args(
                ["--lm", f"gen={LM_SOURCE}", "--decode-slots", "4",
                 "--decode-page-size", "16", "--kv-role", role,
                 "--port", "0"])
            servers.append(cli.build(args))
        (_, pre), (_, dec) = servers
        head = rs.randint(0, VOCAB, PREFIX_TOKENS).tolist()
        prompt = head + rs.randint(0, VOCAB, 40).tolist()
        status, blob, export_ms = post_bytes(
            f"{pre.url}/v1/models/gen/kv/export",
            json.dumps({"prompt": head}).encode(), "application/json")
        if status != 200:
            raise AssertionError(f"kv/export answered {status}")
        status, body, import_ms = post_bytes(
            f"{dec.url}/v1/models/gen/kv/import", blob,
            "application/octet-stream")
        info = json.loads(body)
        if status != 200 or info["adopted"] != PREFIX_TOKENS // 16:
            raise AssertionError(f"kv/import answered {status}: {info}")
        there = post_generate(dec.url, "gen", {"prompt": prompt,
                                               "max_tokens": 24,
                                               "stream": False})
        here = post_generate(pre.url, "gen", {"prompt": prompt,
                                              "max_tokens": 24,
                                              "stream": False})
        if there["cached_tokens"] != PREFIX_TOKENS or \
                there["tokens"] != here["tokens"]:
            raise AssertionError(f"imported prefix: {there['cached_tokens']}"
                                 " cached, tokens equal "
                                 f"{there['tokens'] == here['tokens']}")
        bad = bytearray(blob)
        bad[len(bad) // 2] ^= 0xFF
        status, _, _ = post_bytes(f"{dec.url}/v1/models/gen/kv/import",
                                  bytes(bad), "application/octet-stream")
        if status != 400:
            raise AssertionError(f"a corrupt blob answered {status}")
        alive = post_generate(dec.url, "gen", {"prompt": head[:50],
                                               "max_tokens": 4,
                                               "stream": False})
        ready = json.loads(urllib.request.urlopen(f"{dec.url}/readyz",
                                                  timeout=60).read())
        return {"export_bytes": len(blob), "export_ms": export_ms,
                "import_ms": import_ms, "pages": info["pages"],
                "cached_tokens": there["cached_tokens"],
                "tokens_equal": True, "corrupt_blob_status": status,
                "decode_server_alive": len(alive["tokens"]) == 4,
                "kv_roles": [pre.kv_role, ready["kv_role"]]}
    finally:
        for _, srv in servers:
            srv.drain(timeout=30)


def lm_ops(fa, tmp):
    """Phase 10: the rest of the LM serving runtime, counted from zero:
    (a) rolling swap under traffic, rollback and refusals, (b) a manifest
    directory, (c) speculative decoding at full width, (d) the host spill
    tier, (e) disaggregated prefill between two servers."""
    from deeplearning4j_tpu_torch.serving import cli
    t0 = time.perf_counter()
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    rs = np.random.RandomState(2718)
    args = cli.build_parser().parse_args(
        ["--model", f"lm={LM_SOURCE}", "--buckets", "1,4",
         "--lm", f"gen={LM_SOURCE}",
         "--lm", f"spec={LM_SOURCE}@spec:draft=int8,k=4",
         "--decode-slots", "4", "--decode-page-size", "16", "--port", "0"])
    registry, server = cli.build(args)
    build_s = time.perf_counter() - t0
    try:
        spec = lmops_spec(server.url, registry, rs)
        swap = lmops_swap(fa, server.url, registry, tmp, rs)
        manifest = lmops_manifest(tmp)
        spill = lmops_spill(server.url, tmp, rs)
    finally:
        server.drain(timeout=30)
    disagg = lmops_disagg(rs)
    c8 = lmops_c8(rs)
    launches = dict(fa.KERNEL_LAUNCHES)
    row = {"phase": "lm_ops", "gpu": gpu_line(), "source": LM_SOURCE,
           "seconds": time.perf_counter() - t0, "build_and_warm_s": build_s,
           "flash_launches": launches, "swap": swap, "manifest": manifest,
           "spec": spec, "spill": spill, "disagg": disagg, "c8": c8}
    emit(row)
    if launches["flash_fwd"] == 0 or launches["flash_bwd_dq"] \
            or launches["flash_bwd_dkv"]:
        raise AssertionError(f"lm_ops flash launches: {launches}")
    return {"flash_launches": launches}


# the data_plane phase: ResNet-50 at the bench shape from uint8 shards
# (20 batches of RESNET_BATCH), the LM from token shards, equality at the
# parity shape, the train -> serve handoff
DATA_IMAGES, DATA_CLASSES, DATA_K, DATA_ROUNDS = 1280, 1000, 10, 1
DATA_PARITY_IMAGES, DATA_PARITY_BATCH = 24, 4
HANDOFF_REQUESTS = 8


class _EtlWaits:
    """Listener: the train loop's wait for each chunk's batches (the
    etl_ms fit hands to iteration_done; nonzero once a chunk)."""

    def __init__(self):
        self.etl_ms = []

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        self.etl_ms.append(float(etl_ms))


def _ring_counts(pipe):
    s = pipe.stats
    return (sum(s["batches"].values()), sum(s["decode_s"].values()),
            s["fetch_wait_count"], s["fetch_wait_s"])


def write_image_shards(d, n, hw, classes, seed):
    """n seeded uint8 images (hw, hw, 3) with int class ids through the
    port's ShardWriter, in batches of RESNET_BATCH; fails naming the
    bytes when the directory's file system cannot hold them."""
    import os
    import shutil
    from deeplearning4j_tpu_torch.data.shards import ShardWriter
    need = n * (hw * hw * 3 + 4) + (1 << 20)
    os.makedirs(d)
    free = shutil.disk_usage(d).free
    if free < need:
        raise AssertionError(
            f"data_plane: {d} has {free} bytes free; {n} images of "
            f"{hw}x{hw}x3 need {need} bytes of shards")
    rs = np.random.RandomState(seed)
    t0 = time.perf_counter()
    with ShardWriter(d, shard_records=1024) as w:
        w.num_classes = classes
        for i in range(0, n, RESNET_BATCH):
            m = min(RESNET_BATCH, n - i)
            w.add_batch(rs.randint(0, 256, (m, hw, hw, 3), dtype=np.uint8),
                        rs.randint(0, classes, m).astype(np.int32))
    seconds = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    return size, seconds


def data_resnet(tmp):
    """Phase 11a: ResNet-50 at the bench shape fed from uint8 shards
    through the multi-process ring (default worker count) into
    ComputationGraph.fit(scan_steps=DATA_K), beside the same batches from
    memory, f32 and bf16; the ring's copy=True and copy=False modes."""
    import dataclasses
    import os
    from deeplearning4j_tpu_torch.data.async_iterator import pinned
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.normalization import (
        ImagePreProcessingScaler,
    )
    from deeplearning4j_tpu_torch.data.pipeline import (
        MultiProcessDataSetIterator, ShardBatchLoader, etl_workers,
    )
    from deeplearning4j_tpu_torch.data.shards import ShardDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    if etl_workers(DATA_IMAGES) == 0:
        raise AssertionError(
            "data_plane: the ETL ring resolves to 0 workers "
            "(DL4J_CUDA_ETL_WORKERS=0 or too few cpus); the in-process "
            "path is not measured under the ring's name")
    d = os.path.join(tmp, "images")
    shard_bytes, convert_s = write_image_shards(
        d, DATA_IMAGES, RESNET_HW, DATA_CLASSES, 4242)
    steps = DATA_IMAGES // RESNET_BATCH
    t0 = time.perf_counter()
    memory = [DataSet(np.array(b.features), np.array(b.labels))
              for b in ShardDataSetIterator(d, RESNET_BATCH)]
    load_s = time.perf_counter() - t0
    mem_it = ExistingDataSetIterator(memory).set_pre_processor(
        ImagePreProcessingScaler())
    pin = []
    for _ in range(10):
        t0 = time.perf_counter()
        pinned(memory[0].features)
        pinned(memory[0].labels)
        pin.append((time.perf_counter() - t0) * 1e3)
    staging_ms = statistics.median(pin)
    shm_free = os.statvfs("/dev/shm").f_bavail * os.statvfs(
        "/dev/shm").f_frsize if os.path.isdir("/dev/shm") else None
    pipe = MultiProcessDataSetIterator(
        ShardBatchLoader(d, RESNET_BATCH, num_classes=DATA_CLASSES))
    pipe.set_pre_processor(ImagePreProcessingScaler())
    rows = {}
    try:
        for compute_dtype in (None, "bfloat16"):
            conf = ResNet50().conf()
            if compute_dtype is not None:
                conf = dataclasses.replace(conf, compute_dtype=compute_dtype)
            net = ComputationGraph(conf).init()
            waits = _EtlWaits()
            net.set_listeners(waits)

            def epoch(it):
                n0 = len(waits.etl_ms)
                c0 = _ring_counts(pipe)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net.fit(it, scan_steps=DATA_K)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                c1 = _ring_counts(pipe)
                chunk_waits = [w for w in waits.etl_ms[n0:] if w > 0]
                return {"ms": ms, "consumer_wait_ms": sum(waits.etl_ms[n0:]),
                        "first_chunk_wait_ms": chunk_waits[0]
                        if chunk_waits else 0.0,
                        "ring_batches": c1[0] - c0[0],
                        "worker_decode_s": c1[1] - c0[1],
                        "ring_fetch_waits": c1[2] - c0[2],
                        "ring_fetch_wait_s": c1[3] - c0[3]}

            torch.cuda.reset_peak_memory_stats()
            warm = {"memory": epoch(mem_it), "ring": epoch(pipe)}
            runs = {"memory": [], "ring_copy": [], "ring_view": []}
            for _ in range(DATA_ROUNDS):
                runs["memory"].append(epoch(mem_it))
                pipe._copy = True
                runs["ring_copy"].append(epoch(pipe))
                pipe._copy = False
                runs["ring_view"].append(epoch(pipe))
                pipe._copy = True
            peak = torch.cuda.max_memory_allocated()
            prof = {"memory": launch_profile(
                lambda: net.fit(mem_it, scan_steps=DATA_K), steps),
                "ring_copy": launch_profile(
                lambda: net.fit(pipe, scan_steps=DATA_K), steps)}
            if any(r["ring_batches"] != steps for k in ("ring_copy",
                                                        "ring_view")
                   for r in runs[k]):
                raise AssertionError(f"data_plane: ring batches {runs}")
            step = {k: [r["ms"] / steps for r in v] for k, v in runs.items()}
            median = {k: statistics.median(v) for k, v in step.items()}
            # the run-to-run spread of the memory feed; a ring mode is
            # slower when its median trails memory's by more than that
            spread = max(step["memory"]) - min(step["memory"])
            slower = {k: median[k] - median["memory"] > spread
                      for k in ("ring_copy", "ring_view")}
            fetch_ms = {k: 1e3 * sum(r["ring_fetch_wait_s"] for r in runs[k])
                        / (DATA_ROUNDS * steps)
                        for k in ("ring_copy", "ring_view")}
            pace = {k: "device" if not slower[k] else "fetch_wait"
                    if fetch_ms[k] >= staging_ms else "staging"
                    for k in slower}
            dtype = compute_dtype or "float32"
            rows[dtype] = {
                "step_ms": step, "step_ms_median": median,
                "memory_spread_ms": spread,
                "imgs_per_s": {k: RESNET_BATCH / (v / 1e3)
                               for k, v in median.items()},
                "ring_over_memory": {k: median[k] / median["memory"]
                                     for k in slower},
                "first_chunk_wait_ms": {
                    k: statistics.median(r["first_chunk_wait_ms"] for r in v)
                    for k, v in runs.items()},
                "warm_epoch": warm, "epochs": runs,
                "consumer_wait_ms_per_step": {
                    k: statistics.median(r["consumer_wait_ms"] for r in v)
                    / steps for k, v in runs.items()},
                "ring_fetch_wait_ms_mean": fetch_ms,
                "worker_decode_ms_per_batch": 1e3 * sum(
                    r["worker_decode_s"] for k in fetch_ms for r in runs[k])
                    / (2 * DATA_ROUNDS * steps),
                "ring_slower_than_memory": slower, "pace_set_by": pace,
                "peak_memory_bytes": peak,
                "profile": {k: {m: v[m] for m in (
                    "device_busy_ms_per_step", "idle_share",
                    "host_launch_calls_per_step", "graph_launches_per_step")
                    if m in v} for k, v in prof.items()},
                "score": net.score()}
            if not np.isfinite(net.score()):
                raise AssertionError(f"data_plane {dtype}: {rows[dtype]}")
            del net
            torch.cuda.empty_cache()
        workers = dict(pipe.stats["batches"])
        ring_bytes = pipe.ring_bytes
        n_workers = pipe.num_workers
    finally:
        pipe.close()
    if n_workers < 1 or not workers or "inproc" in workers:
        raise AssertionError(f"data_plane: ring workers {workers}")
    return {"images": DATA_IMAGES, "batch": RESNET_BATCH,
            "image": [RESNET_HW, RESNET_HW, 3], "shard_bytes": shard_bytes,
            "convert_s": convert_s, "load_to_memory_s": load_s,
            "workers": n_workers, "batches_by_worker": workers,
            "ring_slots": pipe._slots_n, "ring_bytes_dev_shm": ring_bytes,
            "dev_shm_free_bytes": shm_free,
            "staging_ms_per_batch": staging_ms,
            "batch_bytes": memory[0].features.nbytes
            + memory[0].labels.nbytes, **rows}


def data_lm(fa, tmp):
    """Phase 11b: the full-width LM from token shards (the train phase's
    set: TRAIN_SEQS sequences of SEQ, next-token labels one-hot uint8)
    through the ring into fit(scan_steps=LM_SCAN_K) over LM_SCAN_STEPS
    steps: the loss falls, the parameters are bitwise those of the same
    batches from the in-process ShardDataSetIterator, and a profiled
    second fit runs each flash kernel n_layers times a step."""
    import os
    from deeplearning4j_tpu_torch.data.pipeline import (
        MultiProcessDataSetIterator, ShardBatchLoader,
    )
    from deeplearning4j_tpu_torch.data.shards import (
        ShardDataSetIterator, ShardWriter,
    )
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.registry import parse_zoo_source
    from deeplearning4j_tpu_torch.train.listeners import (
        CollectScoresIterationListener,
    )
    rs = np.random.RandomState(1234)
    features, labels = write_tokens(os.path.join(tmp, "tokens.npz"), rs)
    d = os.path.join(tmp, "tokens")
    t0 = time.perf_counter()
    with ShardWriter(d, shard_records=16) as w:
        w.add_batch(features, labels)
    convert_s = time.perf_counter() - t0
    epochs = LM_SCAN_STEPS * TRAIN_BATCH // TRAIN_SEQS
    name, kw = parse_zoo_source(LM_SOURCE[len("zoo:"):])
    nets = [model_by_name(name, **kw).init() for _ in range(2)]
    if not _bitwise(nets[0].params, nets[1].params):
        raise AssertionError("data_plane: two inits of the LM differ")
    scores = CollectScoresIterationListener()
    nets[0].set_listeners(scores)
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    with MultiProcessDataSetIterator(ShardBatchLoader(d, TRAIN_BATCH),
                                     num_workers=2) as pipe:
        t0 = time.perf_counter()
        nets[0].fit(pipe, epochs=epochs, scan_steps=LM_SCAN_K)
        torch.cuda.synchronize()
        ring_fit_s = time.perf_counter() - t0
        wrapper = dict(fa.KERNEL_LAUNCHES)
        nets[1].fit(ShardDataSetIterator(d, TRAIN_BATCH), epochs=epochs,
                    scan_steps=LM_SCAN_K)
        bitwise = _bitwise(nets[0].params, nets[1].params)
        del nets[1]
        torch.cuda.empty_cache()
        prof = launch_profile(lambda: nets[0].fit(
            pipe, epochs=epochs, scan_steps=LM_SCAN_K), LM_SCAN_STEPS)
        ring_batches = sum(pipe.stats["batches"].values())
        workers = sorted(pipe.stats["batches"])
    flash = prof.get("flash_kernels_per_step", {})
    launches = {k: int(round(flash.get(k, 0) * LM_SCAN_STEPS))
                for k in KERNELS}
    losses = [s for _, s in scores.scores]
    ok = bool(bitwise and len(losses) == 2 * LM_SCAN_STEPS
              and losses[LM_SCAN_STEPS - 1] < losses[0]
              and all(np.isfinite(losses))
              and all(flash.get(k) == N_LAYERS for k in KERNELS)
              and all(wrapper[k] > 0 for k in KERNELS)
              and ring_batches == 2 * LM_SCAN_STEPS and workers == ["0", "1"])
    row = {"sequences": TRAIN_SEQS, "seq": SEQ, "batch": TRAIN_BATCH,
           "record_bytes": features[0].nbytes + labels[0].nbytes,
           "convert_s": convert_s, "steps": LM_SCAN_STEPS,
           "ring_fit_s": ring_fit_s, "loss_first_last":
           [losses[0], losses[LM_SCAN_STEPS - 1]] if losses else None,
           "bitwise_in_process": bitwise, "wrapper_counts_fit": wrapper,
           "flash_kernels_per_step": flash, "launches": launches,
           "step_profile": {m: prof[m] for m in (
               "device_busy_ms_per_step", "idle_share", "wall_ms")
               if m in prof}, "ok": ok}
    del nets
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"data_plane LM: {row}")
    return row


def data_equality(tmp):
    """Phase 11c: ResNet50 at RESNET_PARITY, batch 4, two chunks of 3,
    cuDNN deterministic, fed from the ring with copy=False, the ring with
    copy=True and memory: bitwise-equal parameters and BN state for
    scan_steps=3, accumulate_steps=2 and per-call fits without
    prefetch."""
    import os
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.normalization import (
        ImagePreProcessingScaler,
    )
    from deeplearning4j_tpu_torch.data.pipeline import (
        MultiProcessDataSetIterator, ShardBatchLoader,
    )
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    hw = RESNET_PARITY["input_shape"][0]
    n, b = DATA_PARITY_IMAGES, DATA_PARITY_BATCH
    d = os.path.join(tmp, "parity")
    write_image_shards(d, n, hw, RESNET_PARITY["num_classes"], 77)
    from deeplearning4j_tpu_torch.data.shards import ShardDataSetIterator
    memory = [DataSet(np.array(x.features), np.array(x.labels))
              for x in ShardDataSetIterator(d, b)]
    path = save_model(ComputationGraph(ResNet50(**RESNET_PARITY).conf(),
                                       device="cpu").init(),
                      os.path.join(tmp, "parity.zip"), compression=STORED)
    rings = {c: MultiProcessDataSetIterator(ShardBatchLoader(d, b),
                                            num_workers=2, copy=c)
             for c in (False, True)}
    for r in rings.values():
        r.set_pre_processor(ImagePreProcessingScaler())
    deterministic = torch.backends.cudnn.deterministic
    saved_prefetch = os.environ.get("DL4J_CUDA_FIT_PREFETCH")
    out = {}
    try:
        torch.backends.cudnn.deterministic = True
        for mode, kw in (("scan3", {"scan_steps": 3}),
                         ("accumulate2", {"accumulate_steps": 2}),
                         ("per_call_no_prefetch", {})):
            if mode == "per_call_no_prefetch":
                os.environ["DL4J_CUDA_FIT_PREFETCH"] = "0"
            nets = {}
            for source in ("ring_view", "ring_copy", "memory"):
                it = rings[source == "ring_copy"] if source != "memory" \
                    else ExistingDataSetIterator(memory).set_pre_processor(
                        ImagePreProcessingScaler())
                net = load_model(path)
                net.fit(it, **kw)
                nets[source] = net
            ref = nets["memory"]
            out[mode] = {s: bool(_bitwise(n_.params, ref.params)
                                 and _bitwise(n_.state, ref.state))
                         for s, n_ in nets.items() if s != "memory"}
            out[mode]["iterations"] = ref.iteration_count
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if saved_prefetch is None:
            os.environ.pop("DL4J_CUDA_FIT_PREFETCH", None)
        else:
            os.environ["DL4J_CUDA_FIT_PREFETCH"] = saved_prefetch
        modes = {c: r._copy for c, r in rings.items()}
        for r in rings.values():
            r.close()
    out["ring_modes_restored"] = modes == {False: False, True: True}
    out["ok"] = bool(out["ring_modes_restored"] and all(
        v["ring_view"] and v["ring_copy"] for k, v in out.items()
        if isinstance(v, dict)))
    if not out["ok"]:
        raise AssertionError(f"data_plane equality: {out}")
    return out


def data_handoff(tmp, environ):
    """Phase 11d: `python -m deeplearning4j_tpu_torch.train --dataset
    mnist --synthetic-data --mode single --serve-port 0` on LeNet in a
    subprocess with `environ`; HANDOFF_REQUESTS predicts over the socket
    equal the reloaded output zip's output() on the card (atol 1e-5:
    batches padded to the serving buckets), then SIGTERM drains it and it
    exits 0."""
    import os
    import signal
    from deeplearning4j_tpu_torch.models.zoo import LeNet
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    src, out = os.path.join(tmp, "lenet.zip"), os.path.join(tmp, "served.zip")
    save_model(LeNet().init(), src)
    cache = os.path.join(tmp, "handoff-datasets")
    os.makedirs(cache)
    env = dict(environ, DL4J_CUDA_DATA_DIR=cache)
    repo = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = repo + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.train", "--model",
         src, "--output", out, "--dataset", "mnist", "--synthetic-data",
         "--mode", "single", "--batch-size", str(MNIST_BATCH),
         "--serve-port", "0", "--serve-buckets", "1,8"],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    lines, announced = [], threading.Event()

    def read_stderr():
        for line in proc.stderr:
            lines.append(line)
            if line.startswith('{"serving"'):
                announced.set()
    threading.Thread(target=read_stderr, daemon=True).start()
    try:
        if not announced.wait(300):
            raise AssertionError("data_plane handoff: no serving line; "
                                 + "".join(lines[-20:]))
        serve_after_s = time.perf_counter() - t0
        info = json.loads(next(x for x in lines
                               if x.startswith('{"serving"')))
        url = info["serving"] + info["predict"]
        net = load_model(out)
        rs = np.random.RandomState(8)
        errs, lat = [], []
        for i in range(HANDOFF_REQUESTS):
            x = rs.rand(1 + i % 8, 28, 28, 1).astype(np.float32)
            status, y, ms = post_npy(url, x)
            lat.append(ms)
            if status != 200:
                raise AssertionError(f"data_plane handoff: HTTP {status}")
            want = net.output(x).float().cpu().numpy()
            errs.append(float(np.abs(y - want).max()) if y.shape
                        == want.shape else float("inf"))
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    result = json.loads(stdout.strip().splitlines()[-1])
    row = {"requests": HANDOFF_REQUESTS, "max_abs_err": max(errs),
           "predict_ms": lat, "serving_after_s": serve_after_s,
           "exit_code": proc.returncode, "cli_result": result,
           "ok": bool(proc.returncode == 0 and max(errs) <= 1e-5
                      and result["iterations"] == 2048 // MNIST_BATCH)}
    if not row["ok"]:
        raise AssertionError(f"data_plane handoff: {row}"
                             + "".join(lines[-20:]))
    return row


def data_plane(fa, tmp):
    """Phase 11: the shard data plane, each part's kernel counts from
    zero: (a) and (c) and (d) launch no flash kernel, (b) each one
    n_layers times a step."""
    t0 = time.perf_counter()
    zero = {k: 0 for k in KERNELS}
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    resnet_rows = data_resnet(tmp)
    after_a = dict(fa.KERNEL_LAUNCHES)
    lm = data_lm(fa, tmp)
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    # (d) beside (c): they share only the card, (c)'s check is bitwise and
    # (d)'s atol 1e-5; (d) gets the environment as it is now ((c) sets a
    # variable in it meanwhile)
    import os
    environ, handoff = dict(os.environ), {}

    def run_handoff():
        try:
            handoff["row"] = data_handoff(tmp, environ)
        except Exception as e:  # noqa: BLE001 — raised below
            handoff["error"] = e

    beside = threading.Thread(target=run_handoff, daemon=True)
    beside.start()
    try:
        equality = data_equality(tmp)
    finally:
        beside.join(timeout=600)    # its subprocess ends with it
    if "error" in handoff:
        raise handoff["error"]
    if "row" not in handoff:
        raise AssertionError("data_plane handoff did not end")
    handoff = handoff["row"]
    after_cd = dict(fa.KERNEL_LAUNCHES)
    row = {"phase": "data_plane", "gpu": gpu_line(),
           "seconds": time.perf_counter() - t0, "resnet": resnet_rows,
           "lm": lm, "equality": equality, "handoff": handoff,
           "flash_launches_resnet": after_a,
           "flash_launches_equality_handoff": after_cd,
           "flash_launches_lm": lm["launches"]}
    emit(row)
    if after_a != zero or after_cd != zero:
        raise AssertionError(f"data_plane: flash launches off the LM path "
                             f"{after_a} {after_cd}")
    return {"flash_launches": lm["launches"]}


# the telemetry phase: the full-width LM through the train CLI with every
# telemetry flag (per call, then fit(scan_steps=10)), ResNet-50 bf16 at
# the bench shape with telemetry off and on, and the LM served with
# /metrics, SLOs, the flight recorder and fault injection
TELE_SEQS, TELE_K = 80, 10              # 20 steps of batch 4 a run
TELE_PREDICTS, TELE_STREAMS, TELE_TOKENS = 64, 4, 64
TELE_RESNET_EPOCHS, TELE_RESNET_ROUNDS = 1, 1
TELE_TRACEPARENT = ("00-0123456789abcdef0123456789abcdef-"
                    "fedcba9876543210-01")
MFU_AGREEMENT = 0.01    # the gauge against the trace's step, relative
# bench.py:277's 24.6 GFLOP an image counts a 4.1 GMAC ResNet-50; the
# zoo's ResNet50 strides its blocks' first 1x1 convolutions (3.86 GMAC)
RESNET_BENCH_FLOPS = RESNET_BATCH * RESNET_FLOP_PER_IMAGE       # 3.149e12
RESNET_STEM_FLOPS = 2 * 112 * 112 * 7 * 7 * 3 * 64   # 7x7x3 -> 64 at 112²


def resnet_train_flops(conf, batch=None):
    """A ResNet train step from the configuration's convolution and dense
    shapes: 3x the forward (the forward, the input and the weight
    gradients) less the stem's input gradient, which no step computes
    (the pixels need none)."""
    batch = RESNET_BATCH if batch is None else batch
    fwd = forward_gflop_per_image(conf) * 1e9
    return batch * (3 * fwd - RESNET_STEM_FLOPS)


def lm_analytic_flops(batch=TRAIN_BATCH):
    """The full-width LM's train step: 6 x the matmul weights x tokens,
    plus the three flash kernels (18·D per causally live pair)."""
    e = HEADS * HEAD_DIM
    gemm = 6 * (12 * e * e * N_LAYERS + e * VOCAB) * batch * SEQ
    flash = 18 * HEAD_DIM * live_pairs(SEQ, SEQ, True) * batch * HEADS \
        * N_LAYERS
    return gemm + flash


def _telemetry_reset():
    """Every process-global telemetry switch off and every store empty."""
    from deeplearning4j_tpu_torch import monitor
    monitor.disable_tracing()
    monitor.clear_trace()
    monitor.goodput.disable_goodput()
    monitor.xla.disable_ledger()
    monitor.xla.clear_ledger()
    monitor.flight.disable_flight()
    monitor.flight.clear()
    monitor.slo.disable_slo()
    monitor.timeseries.disable_timeseries()
    monitor.REGISTRY.reset()


def _tool(*argv):
    """Run one of the repo's stdlib-only tools; (exit code, stdout)."""
    r = subprocess.run([sys.executable, *argv], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        raise AssertionError(f"{argv[0]} exited {r.returncode}: "
                             f"{r.stdout[-2000:]} {r.stderr[-2000:]}")
    return r.stdout


def _write_token_set(path, rs, n):
    start = rs.randint(0, VOCAB, (n, 1))
    stride = rs.randint(1, 8, (n, 1))
    seq = (start + stride * np.arange(SEQ + 1)) % VOCAB
    labels = np.zeros((n, SEQ, VOCAB), np.uint8)
    np.put_along_axis(labels, seq[:, 1:, None], 1, axis=-1)
    np.savez(path, features=seq[:, :SEQ, None].astype("float32"),
             labels=labels)


def _timed_chunk(out_zip, tokens):
    """The trained LM reloaded, its replayed step timed independently of
    the ledger: two chunks of TELE_K batches already on the card (no
    staging; their ids range-checked on the host first, as the prefetch
    thread does, so no dispatch waits on the card), CUDA events around
    the whole fit, after a capture fit. The ledger is on, so each timed
    fit also sets the MFU gauge from its own chunk marks: the gauge and
    the events read the same execution, and a clock change between the
    CLI's run and this replay cannot part them. Per fit: (seconds a step
    by the events, the gauge after the fit, the program's FLOPs a step
    from the replay's own record)."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.util.serialization import load_model
    from deeplearning4j_tpu_torch import monitor
    _telemetry_reset()
    monitor.xla.enable_ledger()
    net = load_model(out_zip)
    with np.load(tokens) as data:
        feats, labels = data["features"], data["labels"]
    batches = []
    for i in range(0, 2 * TELE_K * TRAIN_BATCH, TRAIN_BATCH):
        ds = DataSet(feats[i:i + TRAIN_BATCH], labels[i:i + TRAIN_BATCH])
        net._check_ids(ds)
        ds = DataSet(torch.from_numpy(ds.features).cuda(),
                     torch.from_numpy(ds.labels).cuda())
        ds._host_checked = True
        batches.append(ds)

    def fit():
        net.fit(ExistingDataSetIterator(batches), scan_steps=TELE_K,
                prefetch=False)

    fit()                                   # capture
    runs = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fit()
        end.record()
        torch.cuda.synchronize()
        rec = monitor.xla.latest_record("train")
        runs.append((start.elapsed_time(end) / 1e3 / len(batches),
                     monitor.xla.last_mfu("train"),
                     None if rec is None else rec.flops))
    del net, batches
    torch.cuda.empty_cache()
    _telemetry_reset()
    return runs


def telemetry_train(fa, tmp):
    """Phase 12a: the LM through `python -m deeplearning4j_tpu_torch.train
    --metrics --trace-out --perf-ledger` (train.cli.main in-process), per
    call and with DL4J_CUDA_SCAN_STEPS=10; the ledger, the MFU gauge, the
    goodput partition, the trace and the two stdlib-only readers."""
    import contextlib
    import os
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.registry import parse_zoo_source
    from deeplearning4j_tpu_torch.train import cli as train_cli
    from deeplearning4j_tpu_torch.util.serialization import save_model
    name, kw = parse_zoo_source(LM_SOURCE[len("zoo:"):])
    lm_zip = os.path.join(tmp, "tele_lm.zip")
    tokens = os.path.join(tmp, "tele_tokens.npz")
    save_model(model_by_name(name, **kw).init(), lm_zip, compression=STORED)
    _write_token_set(tokens, np.random.RandomState(12), TELE_SEQS)
    analytic = lm_analytic_flops()
    peak = monitor.xla.PEAK_FLOPS_BY_KIND.get(torch.cuda.get_device_name(0))
    if peak is None:
        raise AssertionError(f"no tabulated peak for "
                             f"{torch.cuda.get_device_name(0)!r}")
    rounds_dir = os.path.join(tmp, "tele_rounds")
    os.makedirs(rounds_dir, exist_ok=True)
    # one synthetic round for perf_report (it needs one artifact; a
    # single round gates nothing), so the repo's banked rounds are not read
    with open(os.path.join(rounds_dir, "BENCH_r01.json"), "w") as f:
        json.dump({"parsed": {"metric": "telemetry_smoke", "value": 1.0,
                              "unit": "runs", "vs_baseline": None,
                              "tpu_unavailable": True, "sweep": []}}, f)
    runs = {}
    for mode, scan in (("per_call", 1), ("scan", TELE_K)):
        _telemetry_reset()
        trace = os.path.join(tmp, f"tele_{mode}_trace.json")
        ledger = os.path.join(tmp, f"tele_{mode}_ledger.json")
        os.environ["DL4J_CUDA_SCAN_STEPS"] = str(scan)
        for k in KERNELS:
            fa.KERNEL_LAUNCHES[k] = 0
        out, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                code = train_cli.main([
                    "--model", lm_zip, "--output",
                    os.path.join(tmp, f"tele_{mode}.zip"), "--dataset",
                    tokens, "--mode", "single", "--batch-size",
                    str(TRAIN_BATCH), "--score-every", "5", "--metrics",
                    "--trace-out", trace, "--perf-ledger", ledger])
        finally:
            del os.environ["DL4J_CUDA_SCAN_STEPS"]
        wall_s = time.perf_counter() - t0
        launches = dict(fa.KERNEL_LAUNCHES)
        result = json.loads(out.getvalue().strip().splitlines()[-1])
        steps = TELE_SEQS // TRAIN_BATCH
        if code != 0 or result["iterations"] != steps:
            raise AssertionError(f"telemetry train {mode}: {code} {result}")
        if any(launches[k] == 0 for k in KERNELS):
            raise AssertionError(f"telemetry train {mode}: {launches}")
        (metrics_line,) = [ln for ln in err.getvalue().splitlines()
                           if ln.startswith('{"metrics"')]
        summary = json.loads(metrics_line)["metrics"]
        doc = json.load(open(ledger))
        (prog,) = doc["programs"]
        want_name = "mln/train_step" if scan == 1 else "mln/scan_step"
        gap = prog["flops"] / analytic - 1.0
        if prog["name"] != want_name or prog["steps_per_call"] != scan \
                or abs(gap) > 0.05:
            raise AssertionError(f"ledger {mode}: {prog} against "
                                 f"{analytic:.4g}")
        if doc["peak_flops"] != peak or doc["device_kind"] \
                != torch.cuda.get_device_name(0):
            raise AssertionError(f"ledger device {doc['device_kind']} "
                                 f"{doc['peak_flops']}")
        events = json.load(open(trace))["traceEvents"]
        spans = [e for e in events if e.get("ph") == "X"]
        counts = {}
        for e in spans:
            counts[e["name"]] = counts.get(e["name"], 0) + 1
        # the MFU gauge beside the program's FLOPs over a measured step:
        # per call, the trace's last `train/step` (the step the gauge was
        # fed); with the graph, a replayed step timed by CUDA events on
        # the reloaded network, independently of the ledger's own clock
        gauge = summary.get("train_mfu_pct")
        gp = monitor.goodput.last_session()
        step_s = [e["dur"] / 1e6 for e in spans if e["name"] == "train/step"]
        replay = None
        if scan == 1:
            measured_s, med_s = step_s[-1], statistics.median(step_s[1:])
            times = step_s
            checked = gauge
        else:
            # the CLI's gauge must be set; its agreement is held on the
            # replay, where the gauge and the events time one execution
            # (the card's clock drifts by ~2 % between two windows)
            if gauge is None:
                raise AssertionError(f"train_mfu_pct unset ({mode})")
            runs_r = _timed_chunk(os.path.join(tmp, f"tele_{mode}.zip"),
                                  tokens)
            times = [t for t, _, _ in runs_r]
            ratios = []
            for t, g, fl in runs_r:
                if g is None or fl is None:
                    raise AssertionError(f"replay gauge unset: {runs_r}")
                ratios.append(g / (100.0 * fl / t / peak))
            i = ratios.index(statistics.median(ratios))
            measured_s, checked = times[i], runs_r[i][1]
            med_s = statistics.median(times)
            replay = {"step_s": times,
                      "train_mfu_pct": [g for _, g, _ in runs_r],
                      "flops_per_step": [fl for _, _, fl in runs_r],
                      "gauge_over_measured": ratios}
        measured = 100.0 * prog["flops"] / measured_s / peak
        if replay is not None:
            measured = 100.0 * runs_r[i][2] / measured_s / peak
        from_median = 100.0 * prog["flops"] / med_s / peak
        if checked is None or abs(checked / measured - 1.0) \
                > MFU_AGREEMENT:
            raise AssertionError(f"train_mfu_pct {checked} against "
                                 f"{measured} measured ({mode})")
        cat_sum = sum(gp["categories"].values())
        if abs(cat_sum - gp["wall_s"]) > 1e-4 * max(1.0, gp["wall_s"]):
            raise AssertionError(f"goodput {mode}: {gp}")
        tr = _tool("-m", "deeplearning4j_tpu_torch.tools.trace_report",
                   trace, "--out",
                   os.path.join(tmp, f"tele_{mode}_merged.json"))
        pr = json.loads(_tool("tools/perf_report.py", "--dir", rounds_dir,
                              "--ledger", ledger, "--json"))
        if not pr["roofline"] or pr["roofline"][0]["name"] != want_name:
            raise AssertionError(f"perf_report roofline {pr['roofline']}")
        runs[mode] = {
            "cli_wall_s": wall_s, "steps": steps, "launches": launches,
            "ledger": {"name": prog["name"], "fingerprint":
                       prog["fingerprint"], "flops_per_step": prog["flops"],
                       "analytic_flops_per_step": analytic,
                       "gap": gap, "steps_per_call": prog["steps_per_call"],
                       "total_flops_per_call": prog["total_flops_per_call"],
                       "bytes_accessed": prog["bytes_accessed"],
                       "arithmetic_intensity":
                           prog["arithmetic_intensity"],
                       "hbm": prog["hbm"],
                       "compile_seconds": prog["compile_seconds"]},
            "train_mfu_pct": gauge, "mfu_checked_pct": checked,
            "mfu_measured_pct": measured, "replay": replay,
            "mfu_from_median_step_pct": from_median,
            "measured_step_s": measured_s, "step_s_median": med_s,
            "step_s": times,
            "goodput": gp, "goodput_category_sum_s": cat_sum,
            "span_counts": counts,
            "trace_report": tr.strip().splitlines()[-3:],
            "perf_report_roofline": pr["roofline"],
            "metrics_summary": summary}
    _telemetry_reset()
    return runs


def _resnet_tele_net(compute_dtype):
    import dataclasses
    from deeplearning4j_tpu_torch.models.zoo import ResNet50
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    conf = ResNet50().conf()
    if compute_dtype is not None:
        conf = dataclasses.replace(conf, compute_dtype=compute_dtype)
    return ComputationGraph(conf).init()


def _telemetry_on():
    from deeplearning4j_tpu_torch import monitor
    monitor.enable_tracing()
    monitor.xla.enable_ledger()
    monitor.goodput.enable_goodput()


def _telemetry_switch(mode):
    """"off": every switch off and every store empty; "on": tracing, the
    ledger and goodput (the metrics record either way)."""
    _telemetry_reset()
    if mode == "on":
        _telemetry_on()


def telemetry_resnet():
    """Phase 12b: ResNet-50 at the bench shape through
    fit(scan_steps=10): telemetry off and everything on (tracing, the
    ledger, goodput, metrics), interleaved; syncs and launch calls a step
    off and on; the ledger's FLOPs; bf16, then f32 once."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.data.normalization import (
        ImagePreProcessingScaler,
    )
    rs = np.random.RandomState(2024)
    x8 = rs.randint(0, 256, (RESNET_BATCH, RESNET_HW, RESNET_HW, 3),
                    dtype=np.uint8)
    y = np.eye(1000, dtype=np.float32)[rs.randint(0, 1000, RESNET_BATCH)]
    batches = [DataSet(x8, y)] * (2 * FIT_K)
    peak = monitor.xla.PEAK_FLOPS_BY_KIND[torch.cuda.get_device_name(0)]

    def make_it(n=2 * FIT_K):
        return ExistingDataSetIterator(batches[:n]).set_pre_processor(
            ImagePreProcessingScaler())

    out = {}
    for dtype in ("bfloat16", None):
        _telemetry_reset()
        net = _resnet_tele_net(dtype)
        analytic = resnet_train_flops(net.conf)
        _telemetry_on()                 # the first fit captures and counts
        net.fit(make_it(), scan_steps=FIT_K)
        (rec,) = monitor.xla.records()
        gap = rec.flops / analytic - 1.0
        if rec.name != "graph/scan_step" or abs(gap) > 0.05:
            raise AssertionError(f"resnet ledger {rec.brief()}: "
                                 f"{rec.flops} against {analytic}")
        steps = TELE_RESNET_EPOCHS * 2 * FIT_K

        def timed():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fit(make_it(), epochs=TELE_RESNET_EPOCHS, scan_steps=FIT_K)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / steps

        row = {"compute_dtype": dtype or "float32",
               "ledger": rec.brief(), "flops_per_step": rec.flops,
               "analytic_flops_per_step": analytic, "gap": gap,
               "bench_py_flops_per_step": RESNET_BENCH_FLOPS,
               "gap_to_bench_py": rec.flops / RESNET_BENCH_FLOPS - 1.0}
        if dtype is None:
            row["step_ms"] = timed()
            row["train_mfu_pct"] = monitor.xla.last_mfu("train")
            row["goodput"] = monitor.goodput.last_session()
            out["f32"] = row
            break
        ms = {"off": [], "on": []}
        for _ in range(TELE_RESNET_ROUNDS):
            for mode in ("off", "on"):
                # the net keeps its ledger record: switching the ledger
                # back on counts nothing again
                _telemetry_switch(mode)
                ms[mode].append(timed())
        mfu = monitor.xla.last_mfu("train")
        gp = monitor.goodput.last_session()
        # syncs in two fits per mode, in turns (a pinned-memory block
        # the host allocator happens to grow can add one to a fit), and
        # one profiled fit per mode
        syncs = {"off": [], "on": []}
        launches = {}
        for mode in ("off", "on", "off", "on"):
            _telemetry_switch(mode)
            net.fit(make_it(), scan_steps=FIT_K)          # warm
            sites, where = sync_sites(lambda: net.fit(make_it(),
                                                      scan_steps=FIT_K))
            syncs[mode].append({"per_step": sum(sites.values())
                                / (2 * FIT_K), "sites": sites,
                                "where": where})
            if mode not in launches:        # one chunk profiled
                launches[mode] = launch_profile(
                    lambda: net.fit(make_it(FIT_K), scan_steps=FIT_K),
                    FIT_K)
        _telemetry_reset()
        min_syncs = {m: min(r["per_step"] for r in v)
                     for m, v in syncs.items()}
        med = {m: statistics.median(v) for m, v in ms.items()}
        spread = {m: max(v) - min(v) for m, v in ms.items()}
        row.update({
            "step_ms": ms, "step_ms_median": med,
            "step_ms_spread": spread,
            "on_minus_off_ms": med["on"] - med["off"],
            "within_off_spread": abs(med["on"] - med["off"])
            <= spread["off"],
            "train_mfu_pct": mfu,
            "mfu_from_median_on_pct":
                100.0 * rec.flops / (med["on"] / 1e3) / peak,
            "goodput": gp, "syncs": syncs, "syncs_per_step": min_syncs,
            "launch_profile": launches})
        out["bf16"] = row
        if min_syncs["off"] != min_syncs["on"]:
            raise AssertionError(f"syncs off/on: {syncs}")
        if launches["off"].get("host_launch_calls_per_step") != \
                launches["on"].get("host_launch_calls_per_step"):
            raise AssertionError(
                f"launch calls off/on: {launches['off']} {launches['on']}")
        if not mfu or mfu <= 0:
            raise AssertionError(f"bf16 train_mfu_pct {mfu}")
        del net
        torch.cuda.empty_cache()
    _telemetry_reset()
    return out


def _scrape(url):
    with urllib.request.urlopen(f"{url}/metrics", timeout=60) as r:
        text = r.read().decode()
    out = {}
    for ln in text.splitlines():
        if ln.startswith("serving_requests_total{"):
            labels = dict(kv.split("=") for kv in
                          ln[ln.index("{") + 1:ln.index("}")].split(","))
            key = (labels["model"].strip('"'), labels["code"].strip('"'))
            out[key] = float(ln.split()[-1])
    return out, text


def _get_json(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, json.loads(r.read())


def _stream_round(url, rs):
    """TELE_STREAMS concurrent greedy streams of TELE_TOKENS tokens on
    `gen`: (results, prompts, tokens/s, ITL p50 ms)."""
    prompts = [rs.randint(0, VOCAB, 32 + 16 * j).tolist()
               for j in range(TELE_STREAMS)]
    results, wall = concurrent_streams(
        url, "gen", [(p, TELE_TOKENS, {}) for p in prompts])
    itl = itl_ms(results)
    return results, prompts, TELE_STREAMS * TELE_TOKENS / wall, \
        statistics.median(itl)


def telemetry_serve(fa, tmp):
    """Phase 12c: the LM served with telemetry on (trace, SLOs, the
    flight recorder, postmortems, fault injection) beside a server
    without it."""
    import os
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.serving import cli
    rs = np.random.RandomState(1212)
    base = ["--model", f"lm={LM_SOURCE}", "--buckets", "1,4",
            "--lm", f"gen={LM_SOURCE}", "--decode-slots", "4",
            "--decode-page-size", "16", "--port", "0"]
    # the server without telemetry first: its tokens/s and ITL
    _telemetry_reset()
    registry, server = cli.build(cli.build_parser().parse_args(
        base + ["--no-flight"]))
    try:
        _, _, off_tps, off_itl = _stream_round(server.url, rs)
    finally:
        server.drain(timeout=30)
    _telemetry_reset()
    pm_dir = os.path.join(tmp, "postmortems")
    trace = os.path.join(tmp, "serve_trace.json")
    registry, server = cli.build(cli.build_parser().parse_args(
        base + ["--trace-out", trace, "--postmortem-dir", pm_dir,
                "--enable-fault-injection", "--slo-p99-ms", "5000",
                "--slo-availability", "0.999",
                "--slo-sample-interval-s", "0.25",
                "--slo-windows", "4,1,8,2"]))
    url = server.url
    try:
        before, _ = _scrape(url)
        for k in KERNELS:
            fa.KERNEL_LAUNCHES[k] = 0
        for i in range(TELE_PREDICTS):
            x = rs.randint(0, VOCAB, (1, SEQ, 1)).astype(np.float32)
            status, y, _ = post_npy(f"{url}/v1/models/lm/predict", x)
            check_answer(status, y, 1)
        predict_launches = dict(fa.KERNEL_LAUNCHES)
        results, prompts, on_tps, on_itl = _stream_round(url, rs)
        net = registry.get("gen").model
        checked = near = 0
        for res, prompt in zip(results, prompts):
            c, n = oracle_check(net, prompt, res["tokens"])
            checked, near = checked + c, near + n
        engine = registry.get("gen").scheduler.admitting_engine()
        if engine.request_path_first_runs:
            raise AssertionError("a decode program first ran on the "
                                 "request path")
        after, text = _scrape(url)
        grew = {k: after.get(k, 0) - before.get(k, 0)
                for k in set(after) | set(before)}
        if grew.get(("lm", "200")) != TELE_PREDICTS or \
                grew.get(("gen", "200")) != TELE_STREAMS:
            raise AssertionError(f"request counters grew {grew}")
        # a traced request: its trace id in the flight recorder
        req = urllib.request.Request(
            f"{url}/v1/models/lm/predict",
            data=json.dumps({"inputs": np.zeros((1, SEQ, 1)).tolist()})
            .encode(), headers={"Content-Type": "application/json",
                                "traceparent": TELE_TRACEPARENT})
        with urllib.request.urlopen(req, timeout=120) as r:
            echoed = r.headers.get("X-Trace-Id")
        # the handler closes its record just after the answer is sent:
        # it is in the ring, or still open
        _, flight = _get_json(f"{url}/v1/debug/flight")
        traced = [rec for rec in flight["records"] + flight["live"]
                  if rec["trace_id"] == TELE_TRACEPARENT.split("-")[1]]
        if echoed != TELE_TRACEPARENT.split("-")[1] or not traced:
            raise AssertionError(f"trace id not in flight: {echoed}")
        ts_status, ts_doc = _get_json(f"{url}/v1/timeseries?series="
                                      "serving_requests_total&window=60")
        slo_status, slo_before = _get_json(f"{url}/v1/slo")
        if ts_status != 200 or not ts_doc["enabled"] or slo_status != 200:
            raise AssertionError(f"timeseries/slo: {ts_doc} {slo_before}")
        # an injected serving fault: counted 5xx, the SLO burns and trips
        status, doc = post_json(f"{url}/v1/faults", {"predict_error": True})
        if status != 200 or not doc["predict_error"]:
            raise AssertionError(f"/v1/faults: {status} {doc}")
        fives0 = _scrape(url)[0].get(("lm", "500"), 0)
        n_fault = 0
        t_fault = time.perf_counter()
        state = None
        while time.perf_counter() - t_fault < 30:
            status, _ = post_json(f"{url}/v1/models/lm/predict",
                                  {"inputs": np.zeros((1, SEQ, 1)).tolist()})
            if status != 500:
                raise AssertionError(f"injected fault answered {status}")
            n_fault += 1
            time.sleep(0.05)
            _, verdict = _get_json(f"{url}/v1/slo")
            state = verdict["state"]
            if state == "firing" and n_fault >= 8:
                break
        fives = _scrape(url)[0].get(("lm", "500"), 0) - fives0
        post_json(f"{url}/v1/faults", {"predict_error": False})
        pms = sorted(os.listdir(pm_dir)) if os.path.isdir(pm_dir) else []
        if fives != n_fault or state != "firing" or not any(
                "slo_availability_burn" in p for p in pms):
            raise AssertionError(f"fault: {fives} 5xx of {n_fault}, slo "
                                 f"{state}, postmortems {pms}")
    finally:
        server.drain(timeout=30)
    n = monitor.save_trace(trace)
    keep_file(trace, "telemetry_serve.json")    # phase 21 merges it
    _telemetry_reset()
    return {"predicts": TELE_PREDICTS, "streams": TELE_STREAMS,
            "tokens_per_stream": TELE_TOKENS,
            "request_counter_growth": {f"{m}/{c}": v
                                       for (m, c), v in grew.items()},
            "predict_flash_launches": predict_launches,
            "oracle_positions": checked, "oracle_near_ties": near,
            "request_path_first_runs": engine.request_path_first_runs,
            "trace_id_in_flight": True, "faulted_requests": n_fault,
            "counted_5xx": fives, "slo_state": state, "postmortems": pms,
            "trace_events": n,
            "tokens_per_s": {"off": off_tps, "on": on_tps},
            "itl_p50_ms": {"off": off_itl, "on": on_itl},
            "metrics_families": len([ln for ln in text.splitlines()
                                     if ln.startswith("# TYPE")])}


def telemetry(fa, tmp):
    """Phase 12: telemetry on the card (see the module docstring)."""
    t0 = time.perf_counter()
    gpu = gpu_line()
    train_runs = telemetry_train(fa, tmp)
    emit({"phase": "telemetry_train", "gpu": gpu, **train_runs})
    resnet_runs = telemetry_resnet()
    emit({"phase": "telemetry_resnet", "gpu": gpu, **resnet_runs})
    served = telemetry_serve(fa, tmp)
    emit({"phase": "telemetry_serve", "gpu": gpu, **served})
    launches = {k: train_runs["per_call"]["launches"][k]
                + train_runs["scan"]["launches"][k] for k in KERNELS}
    row = {"phase": "telemetry", "gpu": gpu,
           "seconds": time.perf_counter() - t0, "flash_launches": launches}
    emit(row)
    return row


# ------------------------------------------------------ phase 13: resilience
# (a): 40 sequences, batch 4, 2 epochs = 20 steps, a checkpoint every 5
RES_SEQS, RES_EPOCHS, RES_SAVE_EVERY = 40, 2, 5
RES_PREEMPT_AT = 7                      # (ii) DL4J_CUDA_FAULTS=preempt_at=7
RES_FAULTS = "transient_at=4;nan_at=6"  # (b)
RES_STEPS = 10                          # (b)-(d) steps a run
RES_RESIDUAL_DROPOUT = 0.1
RES_MEMORY_RATIO = 2.0    # the reference's analytic-vs-compiled bound
RES_SOLVER_REL = 1e-9     # f64 solver scores, card against CPU
RESNET_MEMORY_BATCH = 128
RES_CLI_DRIVER = (
    "import json, sys\n"
    "from deeplearning4j_tpu_torch.ops import flash_attention as fa\n"
    "from deeplearning4j_tpu_torch.train import cli\n"
    "try:\n"
    "    code = cli.main(sys.argv[1:])\n"
    "finally:\n"
    "    print(json.dumps({'flash_launches': dict(fa.KERNEL_LAUNCHES)}),\n"
    "          file=sys.stderr, flush=True)\n"
    "sys.exit(code)\n")


def resilient_lm_conf():
    """The zoo's full-width LM (LM_SOURCE) with residual dropout and no
    attention dropout, so the flash kernels run and the dropout
    generator's state matters."""
    import dataclasses
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.registry import parse_zoo_source
    name, kw = parse_zoo_source(LM_SOURCE[len("zoo:"):])
    conf = model_by_name(name, **kw, dropout=RES_RESIDUAL_DROPOUT).conf()
    return dataclasses.replace(conf, layers=[
        dataclasses.replace(layer, attention_dropout=0.0)
        if hasattr(layer, "attention_dropout") else layer
        for layer in conf.layers])


def zip_entries(path):
    """A checkpoint zip's entries: npz members as {key: array} (their
    members carry write times), the others as bytes."""
    import zipfile
    out = {}
    with zipfile.ZipFile(path) as zf:
        for name in zf.namelist():
            data = zf.read(name)
            if name.endswith(".npz"):
                with np.load(io.BytesIO(data)) as z:
                    out[name] = {k: np.array(z[k]) for k in z.files}
            else:
                out[name] = data
    return out


def same_zip(a, b, skip=()):
    """Whether two checkpoint zips hold the same arrays bitwise (dtypes
    included) and the same other entries byte for byte."""
    za, zb = zip_entries(a), zip_entries(b)
    if sorted(za) != sorted(zb):
        return False
    for name in za:
        if name in skip:
            continue
        x, y = za[name], zb[name]
        if isinstance(x, dict):
            if sorted(x) != sorted(y) or any(
                    x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k])
                    for k in x):
                return False
        elif x != y:
            return False
    return True


def last_checkpoint_extra(directory):
    import zipfile
    from deeplearning4j_tpu_torch.train.resilience import CheckpointManager
    entry = CheckpointManager(directory).latest_valid()
    with zipfile.ZipFile(entry["path"]) as zf:
        extra = json.loads(zf.read("resilience.json"))
    return entry, extra


class _Stopwatch:
    """Wraps CheckpointManager.save and restore_into with wall-clock
    stopwatches (seconds per call, zip bytes per save)."""

    def __init__(self):
        self.save_s, self.save_bytes, self.restore_s = [], [], []

    def __enter__(self):
        import os
        from deeplearning4j_tpu_torch.train.resilience import (
            CheckpointManager,
        )
        self._cls = CheckpointManager
        self._real = (CheckpointManager.save, CheckpointManager.restore_into)
        real_save, real_restore = self._real
        watch = self

        def save(mgr, model, extra):
            t0 = time.perf_counter()
            path = real_save(mgr, model, extra)
            watch.save_s.append(time.perf_counter() - t0)
            watch.save_bytes.append(os.path.getsize(path))
            return path

        def restore_into(mgr, model, path):
            t0 = time.perf_counter()
            out = real_restore(mgr, model, path)
            watch.restore_s.append(time.perf_counter() - t0)
            return out

        CheckpointManager.save = save
        CheckpointManager.restore_into = restore_into
        return self

    def __exit__(self, *exc):
        self._cls.save, self._cls.restore_into = self._real
        return False


def _cli_in_process(fa, argv, env=None):
    """train.cli.main in this process: (exit code, stdout, stderr, flash
    launches of the run)."""
    import contextlib
    import os
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    out, err = io.StringIO(), io.StringIO()
    saved = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        from deeplearning4j_tpu_torch.train import cli as train_cli
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            code = train_cli.main(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        torch.cuda.empty_cache()
    return code, out.getvalue(), err.getvalue(), dict(fa.KERNEL_LAUNCHES)


def _cli_subprocess(argv, kill_after_checkpoints=None, timeout=600,
                    environ=None):
    """`cli.main` in a fresh interpreter (RES_CLI_DRIVER prints the
    wrapper's launch counts on stderr at exit) with `environ` (default
    this process's environment). With `kill_after_checkpoints` =
    (directory, n), a real SIGTERM is sent once the directory's manifest
    lists n checkpoints. (exit code, stdout, stderr, flash launches,
    seconds to the signal or None)."""
    import os
    import signal
    env = dict(os.environ if environ is None else environ,
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    env.pop("DL4J_CUDA_FAULTS", None)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", RES_CLI_DRIVER, *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    signalled = None
    try:
        if kill_after_checkpoints is not None:
            directory, n = kill_after_checkpoints
            manifest = os.path.join(directory, "manifest.json")
            while proc.poll() is None:
                try:
                    with open(manifest) as f:
                        count = len(json.load(f)["checkpoints"])
                except (OSError, ValueError, KeyError):
                    count = 0
                if count >= n:
                    proc.send_signal(signal.SIGTERM)
                    signalled = time.perf_counter() - t0
                    break
                time.sleep(0.02)
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    launches = None
    for line in reversed(stderr.strip().splitlines()):
        if line.startswith('{"flash_launches"'):
            launches = json.loads(line)["flash_launches"]
            break
    return proc.returncode, stdout, stderr, launches, signalled


def _stderr_record(stderr):
    for line in reversed(stderr.strip().splitlines()):
        if line.startswith('{"preempted"'):
            return json.loads(line)
    return None


def resilience_cli(fa, tmp):
    """Phase 13a: the LM through the train CLI's resilient path: (i) an
    uninterrupted run, (ii) preempted by DL4J_CUDA_FAULTS then resumed,
    (iii) a real SIGTERM once two checkpoints are on disk, in a
    subprocess, then resumed; final parameters, optimizer state and the
    last checkpoint's resilience.json bitwise (i)'s."""
    import os
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.util.serialization import save_model
    lm_zip, tokens = os.path.join(tmp, "lm.zip"), os.path.join(tmp, "t.npz")
    save_model(MultiLayerNetwork(resilient_lm_conf()).init(), lm_zip,
               compression=STORED)
    _write_token_set(tokens, np.random.RandomState(1313), RES_SEQS)
    steps = RES_SEQS // TRAIN_BATCH * RES_EPOCHS
    common = ["--model", lm_zip, "--dataset", tokens, "--epochs",
              str(RES_EPOCHS), "--batch-size", str(TRAIN_BATCH),
              "--score-every", "1", "--save-every-iterations",
              str(RES_SAVE_EVERY)]

    def args(run, resume=False):
        return common + ["--output", os.path.join(tmp, f"out_{run}.zip"),
                         "--checkpoint-dir", os.path.join(tmp, f"ck_{run}")] \
            + (["--resume"] if resume else [])

    runs = {}

    # taken here: (ii) sets a variable in this environment meanwhile
    environ = dict(os.environ)

    def iii():
        """(iii) in its own processes, beside (i) and (ii) in this one:
        the runs share no state, and each counts its own launches."""
        try:
            t0 = time.perf_counter()
            code, _, err, launches, signalled = _cli_subprocess(
                args("iii"), environ=environ,
                kill_after_checkpoints=(os.path.join(tmp, "ck_iii"), 2))
            runs["iii_sigterm"] = {
                "exit": code, "wall_s": time.perf_counter() - t0,
                "signal_at_s": signalled, "launches": launches,
                "record": _stderr_record(err),
                "output_zip": os.path.exists(
                    os.path.join(tmp, "out_iii.zip"))}
            t0 = time.perf_counter()
            code, out, err, launches, _ = _cli_subprocess(
                args("iii", True), environ=environ)
            runs["iii_resumed"] = {
                "exit": code, "wall_s": time.perf_counter() - t0,
                "launches": launches, "stderr_tail": err[-400:],
                "result": json.loads(out.strip().splitlines()[-1])
                if code == 0 else None}
        except Exception as e:  # noqa: BLE001 — reported below
            runs["iii_error"] = f"{type(e).__name__}: {e}"

    beside = threading.Thread(target=iii, daemon=True)
    beside.start()
    try:
        monitor.REGISTRY.reset()
        with _Stopwatch() as watch:
            t0 = time.perf_counter()
            code, out, _, launches = _cli_in_process(fa, args("i"))
            runs["i"] = {"exit": code, "wall_s": time.perf_counter() - t0,
                         "launches": launches,
                         "result": json.loads(out.strip().splitlines()[-1])}
            saves_i = list(watch.save_s)
            t0 = time.perf_counter()
            code, _, err, launches = _cli_in_process(
                fa, args("ii"),
                env={"DL4J_CUDA_FAULTS": f"preempt_at={RES_PREEMPT_AT}"})
            runs["ii_preempted"] = {
                "exit": code, "wall_s": time.perf_counter() - t0,
                "launches": launches, "record": _stderr_record(err),
                "output_zip": os.path.exists(
                    os.path.join(tmp, "out_ii.zip"))}
            t0 = time.perf_counter()
            code, out, _, launches = _cli_in_process(fa, args("ii", True))
            runs["ii_resumed"] = {
                "exit": code, "wall_s": time.perf_counter() - t0,
                "launches": launches,
                "result": json.loads(out.strip().splitlines()[-1])}
        hist = {k: monitor.REGISTRY.collect(
            f"resilience_checkpoint_{k}_seconds").snapshot()
            for k in ("save", "restore")}
    finally:
        # a failure here waits for (iii): no process outlives the run
        beside.join(timeout=1200)
    if beside.is_alive() or "iii_resumed" not in runs:
        raise AssertionError(f"the subprocess runs (iii) did not end: "
                             f"{runs.get('iii_error', sorted(runs))}")

    for run in ("i", "ii_resumed", "iii_resumed"):
        r = runs[run]
        if r["exit"] != 0 or r["result"]["iterations"] != steps \
                or r["result"]["epochs"] != RES_EPOCHS:
            raise AssertionError(f"resilient CLI run {run}: {r}")
    for run, at in (("ii_preempted", RES_PREEMPT_AT), ("iii_sigterm", None)):
        r = runs[run]
        rec = r["record"]
        if r["exit"] != 3 or r["output_zip"] or rec is None \
                or rec.get("preempted") is not True \
                or (at is not None and rec["iterations"] != at):
            raise AssertionError(f"preempted CLI run {run}: {r}")
    # each run launched each kernel n_layers times a step it trained
    trained = {"i": steps,
               "ii_preempted": runs["ii_preempted"]["record"]["iterations"],
               "iii_sigterm": runs["iii_sigterm"]["record"]["iterations"]}
    trained["ii_resumed"] = steps - trained["ii_preempted"]
    trained["iii_resumed"] = steps - trained["iii_sigterm"]
    for run, n in trained.items():
        if runs[run]["launches"] != {k: N_LAYERS * n for k in KERNELS}:
            raise AssertionError(f"{run} trained {n} steps with launches "
                                 f"{runs[run]['launches']}")
    if not 0 < trained["iii_sigterm"] < steps:
        raise AssertionError(f"SIGTERM did not land mid-run: {trained}")
    bitwise = {}
    ref_entry, ref_extra = last_checkpoint_extra(os.path.join(tmp, "ck_i"))
    for run in ("ii", "iii"):
        entry, extra = last_checkpoint_extra(os.path.join(tmp, f"ck_{run}"))
        bitwise[run] = {
            "output_zip": same_zip(os.path.join(tmp, "out_i.zip"),
                                   os.path.join(tmp, f"out_{run}.zip")),
            "resilience_json": extra == ref_extra,
            "manifest_counters": (entry["iteration"], entry["epoch"]) == (
                ref_entry["iteration"], ref_entry["epoch"])}
        if not all(bitwise[run].values()):
            raise AssertionError(f"run {run} is not bitwise run i: "
                                 f"{bitwise[run]} {extra} {ref_extra}")
    watch_save, watch_restore = sum(watch.save_s), sum(watch.restore_s)
    agree = {
        "save_hist_s": hist["save"]["sum"], "save_watch_s": watch_save,
        "save_count": [hist["save"]["count"], len(watch.save_s)],
        "restore_hist_s": hist["restore"]["sum"],
        "restore_watch_s": watch_restore,
        "restore_count": [hist["restore"]["count"], len(watch.restore_s)]}
    if hist["save"]["count"] != len(watch.save_s) \
            or hist["restore"]["count"] != len(watch.restore_s) \
            or not abs(hist["save"]["sum"] - watch_save) <= 0.05 * watch_save \
            or not abs(hist["restore"]["sum"] - watch_restore) \
            <= 0.05 * watch_restore:
        raise AssertionError(f"checkpoint histograms vs stopwatch: {agree}")
    flash = {k: sum(r["launches"][k] for r in runs.values())
             for k in KERNELS}
    return {"steps": steps, "save_every": RES_SAVE_EVERY,
            "residual_dropout": RES_RESIDUAL_DROPOUT, "runs": runs,
            "trained_steps": trained, "bitwise_vs_uninterrupted": bitwise,
            "checkpoint_save_s": saves_i,
            "checkpoint_save_s_p50": statistics.median(saves_i),
            "checkpoint_zip_bytes": statistics.median(watch.save_bytes),
            "checkpoint_restore_s": watch.restore_s,
            "histograms_vs_stopwatch": agree, "flash_launches": flash}


class _StepClock:
    """A listener that stamps a CUDA event at each iteration_done (step
    ms between consecutive stamps, past `skip` warm steps) and counts the
    host-device syncs of the iterations after the first
    (`torch.cuda.set_sync_debug_mode`): each counted window holds one
    whole step, from the batch's fetch to the listeners."""

    reads_model = False

    def __init__(self, skip=2):
        self.skip = skip
        self.events = []
        self.syncs = 0
        self._cm = None

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        self._close()

    def iteration_done(self, model, iteration, epoch, score, etl_ms=0.0,
                       batch_size=0):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        self._close()
        self._cm = warnings.catch_warnings(record=True)
        self._caught = self._cm.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")

    def _close(self):
        if self._cm is None:
            return
        torch.cuda.set_sync_debug_mode("default")
        self._cm.__exit__(None, None, None)
        self.syncs += sum("synchroniz" in str(w.message)
                          for w in self._caught)
        self._cm = None

    def result(self):
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
        ms = ms[self.skip:]
        return {"step_ms": ms, "step_ms_p50": statistics.median(ms),
                "syncs_per_step": self.syncs / max(len(self.events) - 1, 1)}


def _device_batches(features, labels, n, start=0):
    """n DataSets of TRAIN_BATCH sequences already on the card, their ids
    range-checked on the host (as the prefetch thread does)."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    out = []
    for i in range(start, start + n):
        sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        out.append(DataSet(torch.from_numpy(features[sl]).cuda(),
                           torch.from_numpy(labels[sl]).cuda()))
    return out


class _Probe:
    """Mixin for a FaultInjector: clones of the flat parameters at the
    first `before_step` of each step index in `at`."""

    def probe(self, net, at):
        self.net, self.at, self.params = net, set(at), {}
        return self

    def before_step(self, step):
        if step in self.at and step not in self.params:
            self.params[step] = self.net.params_flat().clone()
        super().before_step(step)


def resilience_faults(tmp, features, labels):
    """Phase 13b: ResilientTrainer on the LM under DL4J_CUDA_FAULTS
    (a transient error at step 4, a NaN loss at step 6) against the same
    run without faults; then a run of NaN steps that trips
    max_consecutive_skips and rolls back to the newest checkpoint."""
    import os
    import zipfile
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train.resilience import (
        FaultPolicy, ResilientTrainer,
    )
    from deeplearning4j_tpu_torch.util.faults import FaultInjector
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    from deeplearning4j_tpu_torch.util.serialization import (
        _npz_bytes_to_tree, updater_state_to_bytes,
    )

    class Probe(_Probe, FaultInjector):
        pass

    batches = _device_batches(features, labels, RES_STEPS)
    fast = dict(backoff_base=0.001, backoff_max=0.004)
    runs = {}
    for name, env in (("clean", None), ("faulted", RES_FAULTS)):
        net = MultiLayerNetwork(resilient_lm_conf()).init()
        if env is None:
            inj = Probe()
        else:
            os.environ["DL4J_CUDA_FAULTS"] = env
            try:
                inj = Probe.from_env()
            finally:
                os.environ.pop("DL4J_CUDA_FAULTS")
        inj.probe(net, (5, 6, 7))
        rep = ResilientTrainer(net, os.path.join(tmp, f"b_{name}"),
                               policy=FaultPolicy(**fast), injector=inj,
                               write_checkpoints=False).fit(
            ExistingDataSetIterator(batches), epochs=1)
        runs[name] = (rep, inj.params)
        del net
    (rep_c, p_c), (rep_f, p_f) = runs["clean"], runs["faulted"]
    checks = {
        "retries": rep_f.retries, "skipped_steps": rep_f.skipped_steps,
        "retried_step_bitwise": torch.equal(p_f[5], p_c[5]),
        "step_after_retry_bitwise": torch.equal(p_f[6], p_c[6]),
        "skip_restores_bitwise": torch.equal(p_f[7], p_f[6]),
        "clean_retries": rep_c.retries}
    if checks["retries"] != 1 or checks["skipped_steps"] != 1 \
            or checks["clean_retries"] != 0 \
            or not all(checks[k] for k in ("retried_step_bitwise",
                                           "step_after_retry_bitwise",
                                           "skip_restores_bitwise")):
        raise AssertionError(f"faulted LM run: {checks}")
    # a run of NaN steps past max_consecutive_skips: the newest checkpoint
    net = MultiLayerNetwork(resilient_lm_conf()).init()
    rep = ResilientTrainer(
        net, os.path.join(tmp, "b_trip"), save_every_n_iterations=2,
        policy=FaultPolicy(max_consecutive_skips=1, **fast),
        injector=FaultInjector(nan_at=range(3, 100))).fit(
        ExistingDataSetIterator(batches[:6]), epochs=1)
    if not rep.diverged or rep.restored_checkpoint is None:
        raise AssertionError(f"skip threshold did not roll back: {rep}")
    with zipfile.ZipFile(rep.restored_checkpoint) as zf:
        coeffs = _npz_bytes_to_tree(zf.read("coefficients.npz"))
        opt_bytes = zf.read("updaterState.bin")
    want = dict(iter_leaves(coeffs))
    same_params = all(np.array_equal(t.cpu().numpy(), want[path])
                      for path, t in iter_leaves(net.params))
    same_opt = updater_state_to_bytes(net.opt_state) == opt_bytes
    if not (same_params and same_opt):
        raise AssertionError("rolled-back model is not its checkpoint: "
                             f"params {same_params}, updater {same_opt}")
    checks["rollback"] = {"restored": os.path.basename(
        rep.restored_checkpoint), "iteration": net.iteration_count,
        "params_bitwise_zip": same_params,
        "updater_bytes_equal_zip": same_opt}
    del net
    torch.cuda.empty_cache()
    return checks


def resilience_cost(tmp, features, labels):
    """Phase 13c: ms a step by CUDA events and syncs a step for the
    per-call fit, a guarded resilient step and an unguarded one, in
    turns, on batches already on the card; the snapshot's bytes and ms."""
    import os
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.step_graph import tree_tensors
    from deeplearning4j_tpu_torch.train.resilience import (
        FaultPolicy, ResilientTrainer, _grouped_copy,
    )
    batches = _device_batches(features, labels, RES_STEPS)
    net = MultiLayerNetwork(resilient_lm_conf()).init()
    paths = {"per_call": None, "guarded": FaultPolicy(),
             "unguarded": FaultPolicy(max_retries=0, skip_nonfinite=False)}
    rows = {k: {"step_ms": [], "syncs_per_step": []} for k in paths}
    trainer = None
    for name in ("per_call", "guarded", "unguarded", "unguarded", "guarded",
                 "per_call"):
        net.iteration_count = net.epoch_count = 0
        clock = _StepClock()
        net.set_listeners(clock)
        if paths[name] is None:
            net.fit(ExistingDataSetIterator(batches), scan_steps=1,
                    prefetch=False)
        else:
            trainer = ResilientTrainer(net, os.path.join(tmp, "c"),
                                       policy=paths[name],
                                       resume=False, write_checkpoints=False,
                                       save_every_n_iterations=0,
                                       save_every_n_epochs=0)
            trainer.fit(ExistingDataSetIterator(batches), epochs=1)
        r = clock.result()
        rows[name]["step_ms"] += r["step_ms"]
        rows[name]["syncs_per_step"].append(r["syncs_per_step"])
    net.set_listeners()
    for r in rows.values():
        r["step_ms_p50"] = statistics.median(r["step_ms"])
        r["step_ms_min"], r["step_ms_max"] = min(r["step_ms"]), max(
            r["step_ms"])
    # the snapshot alone: the driver's grouped copy and generator state
    gen = net._epoch_generator(7919)
    driver = trainer._driver
    driver.snapshot(gen)
    snap_ms = cuda_ms(lambda: driver.snapshot(gen), iters=20)
    nbytes = driver._snap.nbytes
    # its copies alone, grouped by dtype against one foreach over the
    # mixed list (AdamW's int32 count among f32: the per-tensor path)
    live = tree_tensors(net.params, net.opt_state, net.state)
    bufs = [torch.empty_like(t) for t in live]
    dtypes = {}
    for t in live:
        dtypes[str(t.dtype)] = dtypes.get(str(t.dtype), 0) + 1
    row = {"paths": rows, "snapshot_bytes": nbytes, "snapshot_ms": snap_ms,
           "snapshot_bound_ms": 2 * nbytes / PEAK_BYTES_PER_S * 1e3,
           "copy_tensors": dtypes,
           "copy_mixed_foreach_ms": cuda_ms(
               lambda: torch._foreach_copy_(bufs, live), iters=20),
           "copy_grouped_ms": cuda_ms(lambda: _grouped_copy(bufs, live),
                                      iters=20),
           "guarded_minus_per_call_ms": rows["guarded"]["step_ms_p50"]
           - rows["per_call"]["step_ms_p50"]}
    del net, driver, trainer, live, bufs
    torch.cuda.empty_cache()
    return row


def trace_kernel_names(path):
    """The names of the device kernels in a torch.profiler Chrome trace."""
    with open(path) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel"]


def resilience_listeners(tmp, features, labels):
    """Phase 13d: an async CheckpointListener against a synchronous one
    at the same iteration, its syncs a step; EarlyStoppingTrainer with
    InMemoryModelSaver (the best epoch comes back, not the last); a
    ProfilerListener window naming the three flash kernels."""
    import os
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    from deeplearning4j_tpu_torch.train import (
        CheckpointListener, ProfilerListener,
    )
    from deeplearning4j_tpu_torch.train.earlystopping import (
        EarlyStoppingConfiguration, EarlyStoppingTrainer,
        MaxEpochsTerminationCondition, ScoreCalculator,
    )
    batches = _device_batches(features, labels, 4)
    out = {}
    k = 3
    # a throwaway fit first: the allocator's blocks for a step are then
    # cached, so neither timed run pays for them
    warm = MultiLayerNetwork(resilient_lm_conf()).init()
    warm.fit(ExistingDataSetIterator(batches), scan_steps=1, prefetch=False)
    del warm
    for mode in ("async", "sync"):
        net = MultiLayerNetwork(resilient_lm_conf()).init()
        clock = _StepClock(skip=0)
        d = os.path.join(tmp, f"ckl_{mode}")
        with CheckpointListener(d, save_every_n_iterations=k,
                                async_save=mode == "async") as ck:
            net.set_listeners(ck, clock)
            t0 = time.perf_counter()
            net.fit(ExistingDataSetIterator(batches), scan_steps=1,
                    prefetch=False)
            fit_s = time.perf_counter() - t0
        out[mode] = {"fit_s": fit_s, **clock.result()}
        del net
        torch.cuda.empty_cache()
    same = same_zip(os.path.join(tmp, "ckl_async", f"checkpoint_iter_{k}.zip"),
                    os.path.join(tmp, "ckl_sync", f"checkpoint_iter_{k}.zip"))
    out["async_zip_equals_sync_zip"] = same
    if not same:
        raise AssertionError("the async checkpoint differs from the sync one")

    class Scripted(ScoreCalculator):
        scores = [3.0, 1.0, 2.0, 4.0]

        def calculate(self, model):
            return self.scores.pop(0)

    class EpochParams:
        reads_model = True
        by_epoch = []

        def on_epoch_start(self, model, epoch):
            pass

        def on_epoch_end(self, model, epoch):
            self.by_epoch.append(model.params_flat().clone())

        def iteration_done(self, *a, **kw):
            pass

    net = MultiLayerNetwork(resilient_lm_conf()).init()
    keep = EpochParams()
    net.set_listeners(keep)
    live = tree_leaves(net.params)
    result = EarlyStoppingTrainer(EarlyStoppingConfiguration(
        score_calculator=Scripted(),
        epoch_termination_conditions=[MaxEpochsTerminationCondition(4)]),
        net, (features[:2 * TRAIN_BATCH], labels[:2 * TRAIN_BATCH]),
        batch_size=TRAIN_BATCH).fit()
    best = torch.equal(net.params_flat(), keep.by_epoch[1])
    not_last = not torch.equal(keep.by_epoch[1], keep.by_epoch[3])
    in_place = all(a is b for a, b in zip(live, tree_leaves(net.params)))
    out["early_stopping"] = {"best_epoch": result.best_model_epoch,
                             "epochs": result.total_epochs,
                             "restored_best_bitwise": best,
                             "best_differs_from_last": not_last,
                             "restored_in_place": in_place}
    if result.best_model_epoch != 1 or not (best and not_last and in_place):
        raise AssertionError(f"early stopping: {out['early_stopping']}")
    del net, keep
    net = MultiLayerNetwork(resilient_lm_conf()).init()
    # iteration 1 is the profiler's warm-up, iterations 2-4 the window
    prof = ProfilerListener(os.path.join(tmp, "prof"), start_iteration=2,
                            num_iterations=3)
    net.set_listeners(prof)
    net.fit(ExistingDataSetIterator(
        batches + _device_batches(features, labels, 1, start=4)),
        scan_steps=1, prefetch=False)
    names = trace_kernel_names(prof.trace_path)
    counts = {kname: sum(kname in n for n in names) for kname in KERNELS}
    out["profiler"] = {"trace_bytes": os.path.getsize(prof.trace_path),
                       "kernel_events": len(names), "flash_kernels": counts}
    if counts != {kname: 3 * N_LAYERS for kname in KERNELS}:
        raise AssertionError(f"profiler trace kernels: {counts}")
    del net
    torch.cuda.empty_cache()
    return out


def _net_state(net):
    from deeplearning4j_tpu_torch.nn.step_graph import tree_tensors
    gen = net._dropout_gen
    return ([t.clone() for t in tree_tensors(net.params, net.opt_state,
                                             net.state)],
            None if gen is None else gen.get_state().clone(),
            (net.iteration_count, net.epoch_count, net._score))


def _unchanged(before, after) -> bool:
    return len(before[0]) == len(after[0]) \
        and all(torch.equal(a, b) for a, b in zip(before[0], after[0])) \
        and ((before[1] is None and after[1] is None)
             or torch.equal(before[1], after[1])) and before[2] == after[2]


def resilience_memory(features, labels):
    """Phase 13e: memory_report on the card: the LM at batch 4 (after one
    step, so its optimizer state and generator are live), ResNet-50 bf16
    at batch 128, 224², and the reference's own case (LeNet, batch 16):
    analytic total against the measured peak, and the network bitwise
    unchanged by the report."""
    import dataclasses
    from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
    from deeplearning4j_tpu_torch.models.zoo import ResNet50, model_by_name
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    rows = {}

    def report(name, net, batch):
        before = _net_state(net)
        t0 = time.perf_counter()
        rep = net.memory_report(batch_size=batch)
        secs = time.perf_counter() - t0
        measured = rep.compiled_total_bytes
        rows[name] = {
            "batch": batch, "analytic_train_bytes": rep.total_train_bytes,
            "measured_bytes": measured, "measured": rep.compiled,
            "analytic_over_measured": rep.total_train_bytes / measured,
            "within_2x": 1 / RES_MEMORY_RATIO <= rep.total_train_bytes
            / measured <= RES_MEMORY_RATIO,
            "unchanged": _unchanged(before, _net_state(net)),
            "report_s": secs}
        # the reference holds its bound for LeNet only
        # (tests/test_memory.py:53); the others are reported
        if not rows[name]["unchanged"] or not measured \
                or rep.compiled["temp_bytes"] <= 0 \
                or (name == "lenet" and not rows[name]["within_2x"]):
            raise AssertionError(f"memory_report {name}: {rows[name]}")

    net = MultiLayerNetwork(resilient_lm_conf()).init()
    net.fit(ExistingDataSetIterator(_device_batches(features, labels, 1)),
            prefetch=False)
    report("lm", net, TRAIN_BATCH)
    del net
    torch.cuda.empty_cache()
    conf = dataclasses.replace(ResNet50().conf(), compute_dtype="bfloat16")
    g = ComputationGraph(conf).init()
    report("resnet50_bf16", g, RESNET_MEMORY_BATCH)
    del g
    torch.cuda.empty_cache()
    report("lenet", model_by_name("LeNet").init(), 16)
    torch.cuda.empty_cache()
    return rows


def resilience_solvers():
    """Phase 13f: LBFGS, ConjugateGradient and LineGradientDescent on an
    f64 full-batch logistic regression (the reference test's shape), on
    the card and on the CPU from one zip: score sequences within
    RES_SOLVER_REL, LBFGS converging in fewer iterations than steepest
    descent."""
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    from deeplearning4j_tpu_torch.nn.conf.network import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.layers.feedforward import OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.updaters import Sgd
    from deeplearning4j_tpu_torch.train import solvers
    rs = np.random.RandomState(0)
    centers = rs.randn(3, 6) * 3
    X = np.concatenate([centers[i] + rs.randn(66, 6) for i in range(3)])
    Y = np.eye(3)[np.repeat(np.arange(3), 66)]
    conf = (NeuralNetConfiguration.Builder().seed(0).updater(Sgd(1e-2))
            .dtype("float64").list()
            .layer(OutputLayer(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(InputType.feed_forward(6)).build())
    init = MultiLayerNetwork(conf, device="cpu").init().params_flat()
    rows = {}
    for name in ("LBFGS", "ConjugateGradient", "LineGradientDescent"):
        res = {}
        for dev in ("cuda", "cpu"):
            net = MultiLayerNetwork(conf, device=dev).init()
            net.set_params_flat(init)
            t0 = time.perf_counter()
            r = getattr(solvers, name)(max_iterations=200).optimize(
                net, (X, Y))
            res[dev] = (r, time.perf_counter() - t0)
        (rc, sc), (rh, sh) = res["cuda"], res["cpu"]
        n = min(len(rc.scores), len(rh.scores))
        rel = max(abs(a - b) / max(abs(b), 1e-300)
                  for a, b in zip(rc.scores[:n], rh.scores[:n]))
        rows[name] = {"iterations": [rc.iterations, rh.iterations],
                      "final_score": [rc.final_score, rh.final_score],
                      "max_rel_score_diff": rel, "card_s": sc, "cpu_s": sh}
        if rc.iterations != rh.iterations or not rel <= RES_SOLVER_REL:
            raise AssertionError(f"{name} card vs CPU: {rows[name]}")
    if not rows["LBFGS"]["iterations"][0] \
            < rows["LineGradientDescent"]["iterations"][0]:
        raise AssertionError(f"LBFGS not ahead of steepest descent: {rows}")
    return rows


def resilience(fa, tmp):
    """Phase 13: fault-tolerant training on the card (see the module
    docstring)."""
    import os
    t0 = time.perf_counter()
    gpu = gpu_line()
    _telemetry_reset()          # phase 12 leaves its switches as it found
    cli_run = resilience_cli(fa, tmp)
    emit({"phase": "resilience_cli", "gpu": gpu, **cli_run})
    with np.load(os.path.join(tmp, "t.npz")) as data:
        features, labels = data["features"], data["labels"]
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    faults = resilience_faults(tmp, features, labels)
    emit({"phase": "resilience_faults", "gpu": gpu, **faults})
    cost = resilience_cost(tmp, features, labels)
    emit({"phase": "resilience_cost", "gpu": gpu, **cost})
    lst = resilience_listeners(tmp, features, labels)
    emit({"phase": "resilience_listeners", "gpu": gpu, **lst})
    mem = resilience_memory(features, labels)
    emit({"phase": "resilience_memory", "gpu": gpu, **mem})
    sol = resilience_solvers()
    emit({"phase": "resilience_solvers", "gpu": gpu, **sol})
    row = {"phase": "resilience", "gpu": gpu,
           "seconds": time.perf_counter() - t0,
           "flash_launches": cli_run["flash_launches"],
           "flash_launches_in_process_checks": dict(fa.KERNEL_LAUNCHES)}
    emit(row)
    return row


# ---------------------------------------------------------------- fleet
FLEET_TOL = 1e-6                 # answers against plain attention
FLEET_LATENCY_PAIRS = 15         # (a): per batch size, router and direct
FLEET_RECOVERY_BUDGET_S = 150.0  # the chaos drill's RECOVERY_BUDGET_S
FLEET_CHAOS_TIMEOUT_S = 600
FLEET_DISAGG_PROMPT = 382        # (b): 95 full 4-token KV pages and a half
FLEET_DISAGG_TOKENS = 32         # (b): greedy tokens a stream
FLEET_DISAGG_MIN = 256           # (b): the router disaggregates from here
FLEET_DRILL_TIMEOUT_S = 480
FLEET_ROLLOUT_BUDGET_S = 240.0
FLEET_FIT_STEPS = 2              # (c): v2 is v1 after this many steps
FLEET_V2_GAP = 10                # (c): max|v1 - v2| > this many FLEET_TOL
FLEET_DEVICE = "cuda"            # every replica's --device


def _repo_root() -> str:
    import os
    return os.path.dirname(os.path.abspath(__file__))


def _plain_output(fa, net, x):
    """`net`'s output with the plain attention swapped in for the kernel
    (no launch), on the card."""
    real = fa.flash_attention_cuda
    fa.flash_attention_cuda = \
        lambda q, k, v, mask, causal: fa.flash_attention_plain(
            q, k, v, mask, causal)
    try:
        with torch.no_grad():
            return net.output(x).float().cpu().numpy()
    finally:
        fa.flash_attention_cuda = real


def _tail_logs(directory, n=1500):
    """The last `n` characters of each replica log under `directory`."""
    import os
    out = {}
    if directory and os.path.isdir(directory):
        for fn in sorted(os.listdir(directory)):
            with open(os.path.join(directory, fn), errors="replace") as f:
                out[fn] = f.read()[-n:]
    return out


def _drill(module, argv, timeout, log_dir):
    """Run a fleet drill (`python -m deeplearning4j_tpu_torch.tools.X`) in
    its own process: its router must not share this process's CUDA
    context. Returns its report; a failed drill fails the phase with its
    failures, the end of its output and its replicas' logs (the drill
    writes them beside its report)."""
    import os
    out = os.path.join(log_dir, f"{module}.json")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_repo_root(), env.get("PYTHONPATH")) if p)
    proc = subprocess.run(
        [sys.executable, "-m", f"deeplearning4j_tpu_torch.tools.{module}",
         "--device", FLEET_DEVICE, "--out", out] + argv,
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=_repo_root())
    report = None
    if os.path.exists(out):
        with open(out) as f:
            report = json.load(f)
    if proc.returncode != 0:
        raise AssertionError(
            f"{module} exited {proc.returncode}: failures "
            f"{(report or {}).get('failures')}\nstdout tail: "
            f"{proc.stdout[-3000:]}\nstderr tail: {proc.stderr[-3000:]}\n"
            f"replica logs: "
            f"{_tail_logs(os.path.join(log_dir, module + '_replicas'))}")
    return report


def _no_5xx(codes: dict) -> bool:
    return not any(k.isdigit() and int(k) >= 500 and int(k) != 503
                   for k in codes) and "transport" not in codes


class _RelayClock:
    """Times, inside this process's router, what each proxied predict
    spends: the handler's read of the request body, the transport hop
    (the replica's whole answer read into the router) and the handler's
    reply (the answer written back to the client). Wraps the router's
    handler and its transport while in use; `take()` returns and clears
    the milliseconds since the last take."""

    def __init__(self, fl):
        from deeplearning4j_tpu_torch.serving import router as router_mod
        self._handler = router_mod._RouterHandler
        self._router = fl.router
        self._ms = {}

    def _timed(self, fn, key):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self._ms[key] = self._ms.get(key, 0.0) + \
                    (time.perf_counter() - t0) * 1e3
        return wrapper

    def __enter__(self):
        self._saved = (self._handler._body, self._handler._reply,
                       self._router._transport)
        self._handler._body = self._timed(self._saved[0], "request_body")
        self._handler._reply = self._timed(self._saved[1], "reply")
        self._router._transport = self._timed(self._saved[2], "transport")
        return self

    def __exit__(self, *exc):
        (self._handler._body, self._handler._reply,
         self._router._transport) = self._saved

    def take(self) -> dict:
        out, self._ms = self._ms, {}
        return out


def _spread(xs) -> dict:
    q = statistics.quantiles(xs, n=4)
    return {"n": len(xs), "median": statistics.median(xs), "p25": q[0],
            "p75": q[2], "min": min(xs), "max": max(xs)}


def _quiesce(fa, served, timeout_s=30.0):
    """The kernel launches and each replica's dispatches once neither
    moved for half a second (a hedged predict's twin may still be running
    when the first answer is back)."""
    def read():
        return (dict(fa.KERNEL_LAUNCHES),
                {n: s.batcher.dispatches for n, s in served.items()})
    deadline = time.monotonic() + timeout_s
    last = read()
    while time.monotonic() < deadline:
        time.sleep(0.5)
        now = read()
        if now == last:
            return now
        last = now
    raise AssertionError(f"the fleet never went quiet: {last}")


def fleet_inprocess(fa, v1_zip, gpu):
    """14 (a): the CLI's fleet mode, two in-process replicas of the
    full-width LM on the card behind the router; every predict runs the
    flash forward kernel in the replica that served it. The router's
    added latency: FLEET_LATENCY_PAIRS inputs per batch size, each sent
    through the router and straight to replica 0 in turn (which goes
    first alternates), with the relay's parts timed inside the router."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.serving import cli
    from deeplearning4j_tpu_torch.util.serialization import load_model
    args = cli.build_parser().parse_args(
        ["--model", f"lm={v1_zip}", "--replicas", "2", "--replica-mode",
         "inprocess", "--buckets", "1,4", "--max-delay-ms", "5",
         "--device", FLEET_DEVICE, "--port", "0"])
    rs = np.random.RandomState(1414)
    xs = [rs.randint(0, VOCAB, (4 if i % 2 else 1, SEQ, 1)).astype("float32")
          for i in range(2 * FLEET_LATENCY_PAIRS)]
    burst = [rs.randint(0, VOCAB, (1, SEQ, 1)).astype("float32")
             for _ in range(4)]
    # the plain references before the fleet runs: `_plain_output` swaps
    # the kernel out for the whole process, and a hedged predict's twin
    # may still run on a replica after the first answer is back
    t0 = time.perf_counter()
    ref = load_model(v1_zip, device=FLEET_DEVICE)
    wants = [_plain_output(fa, ref, x) for x in xs + burst]
    del ref
    refs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fl = cli.build_fleet(args)
    build_s = time.perf_counter() - t0
    try:
        served = {r.name: r._registry.get("lm")
                  for r in fl.supervisor.replicas}
        warm = {n: s.batcher.dispatches for n, s in served.items()}
        routes = (("router", fl.url),
                  ("direct", fl.supervisor.replicas[0].url))
        lat = {route: {1: [], 4: []} for route, _ in routes}
        relay = {1: [], 4: []}
        err = 0.0
        with _RelayClock(fl) as clock:
            for i, (x, want) in enumerate(zip(xs, wants)):
                batch = x.shape[0]
                for route, url in (routes if i // 2 % 2 else routes[::-1]):
                    clock.take()
                    status, y, ms = post_npy(f"{url}/v1/models/lm/predict",
                                             x)
                    check_answer(status, y, batch)
                    err = max(err, float(np.abs(y - want).max()))
                    lat[route][batch].append(ms)
                    if route == "router":
                        relay[batch].append(clock.take())
        results = [None] * 4

        def one(j):
            results[j] = post_npy(f"{fl.url}/v1/models/lm/predict", burst[j])

        threads = [threading.Thread(target=one, args=(j,)) for j in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        for want, r in zip(wants[len(xs):], results):
            if r is None:
                raise AssertionError("a concurrent predict never returned")
            check_answer(r[0], r[1], 1)
            err = max(err, float(np.abs(r[1] - want).max()))
        launches, dispatches = _quiesce(fa, served)
        if launches["flash_bwd_dq"] or launches["flash_bwd_dkv"]:
            raise AssertionError("the fleet's predicts launched a backward "
                                 "kernel")
        if launches["flash_fwd"] != N_LAYERS * sum(dispatches.values()):
            raise AssertionError(
                f"{launches['flash_fwd']} forward launches for "
                f"{dispatches} dispatches of a {N_LAYERS}-layer network")
        if not all(dispatches[n] > warm[n] for n in served):
            raise AssertionError(f"a replica served nothing: warm {warm}, "
                                 f"after {dispatches}")
        if not err <= FLEET_TOL:
            raise AssertionError(f"fleet answers vs plain attention: {err}")
        hedges = monitor.REGISTRY.collect("serving_router_hedges_total")
        added, relay_ms = {}, {}
        for b in (1, 4):
            router_ms, direct_ms = lat["router"][b], lat["direct"][b]
            added[str(b)] = _spread([r - d for r, d in
                                     zip(router_ms, direct_ms)])
            parts = {k: [t.get(k, 0.0) for t in relay[b]]
                     for k in ("request_body", "transport", "reply")}
            relay_ms[str(b)] = {
                **{k: statistics.median(v) for k, v in parts.items()},
                # the hop to the replica beyond a direct request's time
                "transport_over_direct": statistics.median(
                    t - d for t, d in zip(parts["transport"], direct_ms)),
                # the client's time outside the three timed parts
                "rest": statistics.median(
                    r - sum(parts[k][j] for k in parts)
                    for j, r in enumerate(router_ms))}
        row = {"phase": "fleet_inprocess", "gpu": gpu,
               "replicas": len(served), "plain_references_s": refs_s,
               "build_and_warm_s": build_s,
               "requests": sum(len(v) for d in lat.values()
                               for v in d.values()) + len(burst),
               "latency_ms": {route: {str(b): _spread(v)
                                      for b, v in d.items()}
                              for route, d in lat.items()},
               "router_added_ms": added, "relay_ms": relay_ms,
               "dispatches": dispatches, "warmup_dispatches": warm,
               "flash_fwd_launches": launches["flash_fwd"],
               "hedges": 0 if hedges is None else hedges.value(model="lm"),
               "max_abs_err_vs_plain": err}
        emit(row)
        return row
    finally:
        cli.drain_fleet(fl, drain_timeout_s=2.0)


def fleet_chaos(fa, v1_zip, tmp, gpu):
    """14 (b): the port's chaos drill at full width, 3 subprocess
    replicas of v1 (its own process: the router must hold no card
    memory), then its disaggregation drill on v1 as an LM servable; the
    transferred streams' greedy tokens against a single server's."""
    from deeplearning4j_tpu_torch.serving.decode import DecodeConfig
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    from deeplearning4j_tpu_torch.serving.server import ModelServer
    t0 = time.perf_counter()
    rep = _drill("serve_chaos",
                 ["--model", v1_zip, "--vocab", str(VOCAB), "--npy",
                  "--buckets", "1,4", "--lm", v1_zip,
                  "--disagg-prompt-tokens", str(FLEET_DISAGG_PROMPT),
                  "--disagg-max-tokens", str(FLEET_DISAGG_TOKENS),
                  "--disagg-min-tokens", str(FLEET_DISAGG_MIN)],
                 FLEET_CHAOS_TIMEOUT_S, tmp)
    drill_s = time.perf_counter() - t0
    for part in ("baseline", "under_fault", "recovered"):
        if not _no_5xx(rep[part]["codes"]):
            raise AssertionError(f"chaos {part}: {rep[part]['codes']}")
    faulted = (rep["faults"]["killed"], rep["faults"]["wedged"])
    ready_s = rep["recovery"]["fault_to_ready_s"]
    if sorted(ready_s) != sorted(faulted) or not all(
            v <= FLEET_RECOVERY_BUDGET_S for v in ready_s.values()):
        raise AssertionError(f"faulted replicas' fault-to-ready: {ready_s}")
    if not rep["shed"]["batch"] > 0:
        raise AssertionError(f"no batch-class shedding: {rep['shed']}")
    if rep.get("router_card_memory_mib") != 0:
        raise AssertionError("the drill's router holds card memory: "
                             f"{rep.get('router_card_memory_mib')} MiB")
    streams = [s for s in rep["disagg"]["streams"]
               if s["phase"] == "before_kill" and s["transferred"]]
    if not streams:
        raise AssertionError("no stream rode a completed KV transfer")
    if any(len(s["prompt"]) != FLEET_DISAGG_PROMPT
           or len(s["tokens"]) != FLEET_DISAGG_TOKENS for s in streams):
        raise AssertionError("a transferred stream's lengths: " + str(
            [(len(s["prompt"]), len(s["tokens"])) for s in streams]))
    registry = ModelRegistry(device=FLEET_DEVICE)
    single = registry.deploy_lm("lm", v1_zip,
                                decode=DecodeConfig(slots=4, page_size=4))
    # a replica's LM warms (and captures) the same programs at its start
    single_graphs = single.scheduler.admitting_engine().describe_graphs()
    server = ModelServer(registry, port=0)
    try:
        mismatched = []
        for s in streams:
            status, doc = post_json(
                f"{server.url}/v1/models/lm/generate",
                {"prompt": s["prompt"], "max_tokens": len(s["tokens"]),
                 "temperature": 0.0, "stream": False})
            if status != 200 or doc["tokens"] != s["tokens"]:
                mismatched.append((s["prompt"], s["tokens"],
                                   doc.get("tokens")))
    finally:
        server.drain(timeout=30)
    if mismatched:
        raise AssertionError("disaggregated greedy tokens differ from a "
                             f"single server's: {mismatched}")
    row = {"phase": "fleet_chaos", "gpu": gpu, "drill_s": drill_s,
           "fleet_start_s": rep["fleet_start_s"],
           "launch_to_ready_s": rep["launch_s"],
           "lm_warm_s_in_a_start": single.warmup_seconds,
           "lm_capture_s_in_a_start": single_graphs["capture_s"],
           "kill_to_ready_s": ready_s[rep["faults"]["killed"]],
           "wedge_to_ready_s": ready_s[rep["faults"]["wedged"]],
           "relaunch_s": rep["recovery"]["relaunch_s"],
           "p99_ms": {"baseline": rep["baseline"]["p99_ms"],
                      "under_fault": rep["under_fault"]["p99_ms"],
                      "recovered": rep["recovered"]["p99_ms"],
                      "recovery_budget": rep["recovered"]["p99_budget_ms"]},
           "goodput_under_fault_rps": rep["under_fault"]["goodput_rps"],
           "codes_under_fault": rep["under_fault"]["codes"],
           "shed": rep["shed"], "hedges": rep["hedges"],
           "fleet_restarts_total": rep["fleet_restarts_total"],
           "slo_alert_events": [h["event"] for h in rep["slo_alerts"]],
           "router_card_memory_mib": rep.get("router_card_memory_mib"),
           "disagg": {"launch_to_ready_s": rep["disagg"]["launch_s"],
                      "orchestrations_before_kill":
                          rep["disagg"]["orchestrations_before_kill"],
                      "failovers": rep["disagg"]["failovers"],
                      "codes": rep["disagg"]["codes"],
                      "prompt_tokens": FLEET_DISAGG_PROMPT,
                      "kv_pages_per_transfer": -(-FLEET_DISAGG_PROMPT // 4),
                      "greedy_tokens": FLEET_DISAGG_TOKENS,
                      "streams_equal_single_server": len(streams)}}
    emit(row)
    return row


def _canary_requests(fl, canary, v2_path, bless_unix):
    """The canary replica's predicts from its flight recorder, by when
    they started: before the blessing, while the replica loaded v2 (from
    the blessing to v2's load time, the version's `loaded_at`), while
    it warmed v2 (to the swap's return: v2 live, where the rollout's
    observation window opens) and after; count, p50 and max ms of each,
    and the three slowest with their start (s from v2 live) and
    timeline."""
    rep = next(r for r in fl.supervisor.replicas
                if r.name == canary["replica"])
    _, doc = _get_json(f"{rep.url}/v1/debug/flight")
    _, model = _get_json(f"{rep.url}/v1/models/lm")
    loaded = next(v["loaded_at"] for v in model["versions"]
                  if v["source"] == v2_path)
    live = canary["started_unix"]
    recs = [r for r in doc.get("records", []) if r.get("kind") == "predict"
            and r.get("duration_ms") is not None]

    def side(lo, hi):
        ms = sorted(r["duration_ms"] for r in recs
                    if lo <= r["start_unix"] < hi)
        return {"n": len(ms), "p50_ms": ms[len(ms) // 2] if ms else None,
                "max_ms": ms[-1] if ms else None}
    slowest = sorted(recs, key=lambda r: r["duration_ms"])[-3:]
    return {"v2_load_s": loaded - bless_unix, "v2_warm_s": live - loaded,
            "before_blessing": side(-math.inf, bless_unix),
            "during_v2_load": side(bless_unix, loaded),
            "during_v2_warm": side(loaded, live),
            "after_v2_live": side(live, math.inf),
            "slowest": [{"start_s_from_v2_live":
                         round(r["start_unix"] - live, 3),
                         "duration_ms": r["duration_ms"],
                         "events": r.get("events", [])[:8]}
                        for r in slowest]}


def fleet_rollout(fa, v1_zip, tmp, gpu):
    """14 (c): v2 = v1 after two fit steps on the card (the flash
    backward kernels run here), saved and blessed with the port's
    CheckpointManager into the directory a 3-replica subprocess fleet
    tails; canary, promote, zero 5xx, every replica v2's answers. Then
    the port's rollout drill on the card."""
    import os

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
    from deeplearning4j_tpu_torch.serving import cli
    from deeplearning4j_tpu_torch.tools.loadgen import LoadGen
    from deeplearning4j_tpu_torch.tools.rollout_drill import _Pump
    from deeplearning4j_tpu_torch.train.resilience import CheckpointManager
    from deeplearning4j_tpu_torch.util.serialization import load_model
    rs = np.random.RandomState(2024)
    x = rs.randint(0, VOCAB, (2, SEQ, 1)).astype("float32")
    n = TRAIN_BATCH * FLEET_FIT_STEPS
    seq = rs.randint(0, VOCAB, (n, SEQ + 1))
    labels = np.zeros((n, SEQ, VOCAB), np.uint8)
    np.put_along_axis(labels, seq[:, 1:, None], 1, axis=-1)
    net = load_model(v1_zip, device=FLEET_DEVICE)
    v1_out = _plain_output(fa, net, x)
    before = dict(fa.KERNEL_LAUNCHES)
    net.fit(ArrayDataSetIterator(seq[:, :SEQ, None].astype("float32"),
                                 labels, batch_size=TRAIN_BATCH))
    fit_launches = {k: fa.KERNEL_LAUNCHES[k] - before[k] for k in KERNELS}
    if any(v != N_LAYERS * FLEET_FIT_STEPS for v in fit_launches.values()):
        raise AssertionError(f"v2's fit launched {fit_launches}")
    ckdir = os.path.join(tmp, "rollout_ckpts")
    os.makedirs(ckdir)
    args = cli.build_parser().parse_args(
        ["--model", f"lm={v1_zip}", "--replicas", "3", "--buckets", "1,4",
         "--device", FLEET_DEVICE, "--port", "0", "--probe-interval-s", "0.5",
         "--rollout-watch", ckdir, "--rollout-poll-s", "0.5",
         "--rollout-observe-s", "5", "--rollout-min-requests", "5",
         "--rollout-canary-fraction", "0.5",
         "--rollout-p99-floor-ms", "1000", "--slo-availability", "0.99",
         "--slo-sample-interval-s", "0.5"])
    t0 = time.perf_counter()
    fl = cli.build_fleet(args)
    start_s = time.perf_counter() - t0

    class Args:
        url = fl.url
        model = "lm"
        requests = 16
        concurrency = 3
        rate = None
        batch_sizes = [1, 4]
        priority_mix = None
        max_retries = 4
        retry_cap_s = 2.0
        deadline_ms = None
        timeout_s = 120.0
        seed = 5
        vocab = VOCAB
        npy = True

    try:
        pump = _Pump(LoadGen(Args, (SEQ, 1))).start()
        v2_path = CheckpointManager(ckdir).save(net, {})
        t_bless, bless_unix = time.perf_counter(), time.time()
        CheckpointManager(ckdir).bless(v2_path, {"fit_steps":
                                                 FLEET_FIT_STEPS})
        canary_seen, canary_doc, verdict = None, None, None
        deadline = time.monotonic() + FLEET_ROLLOUT_BUDGET_S
        while time.monotonic() < deadline:
            ro = fl.rollout.describe()
            if ro["state"] == "canary" and canary_seen is None:
                canary_seen = ro["canary"]["replica"]
                canary_doc = dict(ro["canary"])
            verdict = ro["last_verdict"]
            if verdict is not None:
                break
            time.sleep(0.1)
        bless_to_verdict_s = time.perf_counter() - t_bless
        traffic = pump.stop()
        canary_requests = None if canary_doc is None \
            else _canary_requests(fl, canary_doc, v2_path, bless_unix)
        if pump.crashed:
            raise AssertionError(f"traffic pump crashed: {pump.crashed}")
        if verdict is None or verdict["decision"] != "promoted":
            raise AssertionError(f"v2 not promoted: {verdict}; rollout "
                                 f"{fl.rollout.describe()}")
        if canary_seen is None:
            raise AssertionError("the rollout never showed its canary")
        if not _no_5xx(traffic["codes"]):
            raise AssertionError(f"5xx during the rollout: "
                                 f"{traffic['codes']}")
        want = _plain_output(fa, net, x)
        # the check below tells v2 from v1 only if they differ by more
        v1_gap = float(np.abs(want - v1_out).max())
        if not v1_gap > FLEET_V2_GAP * FLEET_TOL:
            raise AssertionError(f"v2's answers are within {v1_gap} of "
                                 "v1's: the check cannot tell them apart")
        errs, actives = {}, {}
        for r in fl.supervisor.replicas:
            status, y, _ = post_npy(f"{r.url}/v1/models/lm/predict", x)
            if status != 200:
                raise AssertionError(f"{r.name} answered {status}")
            errs[r.name] = float(np.abs(y - want).max())
            _, doc = _get_json(f"{r.url}/v1/models/lm")
            actives[r.name] = [v["source"] for v in doc["versions"]
                               if v["version"] == doc["active_version"]]
        if not all(e <= FLEET_TOL for e in errs.values()):
            raise AssertionError(f"replicas vs v2's plain output: {errs}")
        if set(map(tuple, actives.values())) != {(v2_path,)} or \
                fl.supervisor.replicas[0].spec.models != [("lm", v2_path)]:
            raise AssertionError(f"the fleet after promotion: {actives}, "
                                 f"{fl.supervisor.replicas[0].spec.models}")
    finally:
        cli.drain_fleet(fl, drain_timeout_s=5.0)
        monitor.slo.disable_slo()
        monitor.timeseries.disable_timeseries()
    t0 = time.perf_counter()
    drill = _drill("rollout_drill", [], FLEET_DRILL_TIMEOUT_S, tmp)
    drill_s = time.perf_counter() - t0
    rb = drill["rollback"]
    if rb["verdict"]["metric"] != "probe_accuracy" \
            or rb["postmortem_metric"] != "probe_accuracy" \
            or not rb["verdict"]["rolled_back"]:
        raise AssertionError(f"the poisoned blessing: {rb}")
    if drill["autoscale"]["forced_kills"] != 0 or \
            drill["autoscale"]["peak_replicas"] <= \
            drill["autoscale"]["initial_replicas"]:
        raise AssertionError(f"autoscale: {drill['autoscale']}")
    sweep = drill["sweep"][0]
    row = {"phase": "fleet_rollout", "gpu": gpu,
           "fit_launches": fit_launches, "fleet_start_s": start_s,
           "canary": canary_seen,
           "observe_s": verdict["observe_s"],
           "promote_s": verdict["promote_s"],
           "bless_to_promoted_s": bless_to_verdict_s,
           "traffic": {"requests": traffic["requests"],
                       "codes": traffic["codes"],
                       "p99_ms": traffic["latency_ms"]["p99"]},
           "canary_requests": canary_requests,
           "verdict_stats": verdict.get("stats"),
           "max_abs_err_vs_v2_plain": errs, "max_abs_v1_v2": v1_gap,
           "drill": {"seconds": drill_s,
                     "rollout_promote_s": sweep["rollout_promote_s"],
                     "rollout_rollback_detect_s":
                         sweep["rollout_rollback_detect_s"],
                     "promote_codes": drill["promote"]["codes"],
                     "rollback_codes": drill["rollback"]["codes"],
                     "autoscale_peak_replicas":
                         drill["autoscale"]["peak_replicas"],
                     "forced_kills": drill["autoscale"]["forced_kills"],
                     "fleet_start_s": drill["fleet_start_s"]}}
    emit(row)
    return row


def fleet(fa, tmp):
    """Phase 14: the serving fleet on the card."""
    import os

    from deeplearning4j_tpu_torch.monitor import flight
    from deeplearning4j_tpu_torch.serving.registry import load_servable
    from deeplearning4j_tpu_torch.util.serialization import save_model
    gpu = gpu_line()
    t0 = time.perf_counter()
    torch.cuda.empty_cache()         # the subprocess replicas share the card
    v1_zip = os.path.join(tmp, "v1.zip")
    net = load_servable(LM_SOURCE, device=FLEET_DEVICE)
    save_model(net, v1_zip, compression=STORED)
    params = net.num_params()
    del net
    for name in KERNELS:
        fa.KERNEL_LAUNCHES[name] = 0
    try:
        a = fleet_inprocess(fa, v1_zip, gpu)
        b = fleet_chaos(fa, v1_zip, tmp, gpu)
        c = fleet_rollout(fa, v1_zip, tmp, gpu)
    finally:
        flight.disable_flight()
    launches = dict(fa.KERNEL_LAUNCHES)
    if not all(launches[k] > 0 for k in KERNELS):
        raise AssertionError(f"a kernel of the fleet path never launched: "
                             f"{launches}")
    emit({"phase": "fleet", "gpu": gpu, "seconds": time.perf_counter() - t0,
          "source": LM_SOURCE, "params": params, "flash_launches": launches,
          "router_added_ms_median": {b: v["median"] for b, v in
                                     a["router_added_ms"].items()},
          "kill_to_ready_s": b["kill_to_ready_s"],
          "wedge_to_ready_s": b["wedge_to_ready_s"],
          "rollout_promote_s": c["drill"]["rollout_promote_s"],
          "rollout_rollback_detect_s":
              c["drill"]["rollout_rollback_detect_s"]})
    return {"flash_launches": launches}


# ------------------------------------------------------- phase 15: parallel
# the parallel phase: 40 sequences at batch 4 = 10 steps a CLI run; the
# two-rank runs take 16 sequences (4 steps of global batch 4, 2 a rank)
PAR_SEQS, PAR_STEPS, PAR_RANK_SEQS = 40, 10, 16
PAR_RANK_STEPS = PAR_RANK_SEQS // TRAIN_BATCH
# two ranks against one rank, leaf by leaf: the first batch's summed
# gradient within 1e-5 of each leaf's own norm, the loss within 1e-5; the
# parameters after the first AdamW step within 1e-5 of each leaf's update
# norm, after 4 steps within 1e-4, both over the elements whose first
# gradient is at least 1e-6. Below that AdamW's update g / (|g| + 1e-8) is
# ill-conditioned: the gradient's rounding (5e-10 measured) moves it by a
# good part of lr. The two ranks are also held bitwise to one process
# that sums the two halves' gradients, which covers every element.
PAR_GRAD_TOL = PAR_UPDATE_TOL = 1e-5
PAR_DRIFT_TOL = 1e-4
PAR_CONDITIONED_GRAD = 1e-6
PAR_GRAD_FLOATS = 13651968      # the LM's f32 gradient (54.6 MB)
# (a)'s step time: the plain step and the plan's, interleaved in pairs
PAR_STEP_PAIRS = 20
# (b) and (d) run as two ranks in their own processes on the one card
PAR_SCRIPT = r'''
import hashlib, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.parallel.distributed import (
    DistributedConfig, initialize_distributed, shutdown_distributed)
from deeplearning4j_tpu_torch.util.platform import set_f32_matmul_exact
from deeplearning4j_tpu_torch.util.serialization import load_model

part, rank, coord, lm_zip, tokens, out, port = sys.argv[1:8]
rank = int(rank)
set_f32_matmul_exact()
data = np.load(tokens)
X, Y = data["features"], data["labels"]


def digest(net):
    return hashlib.sha256(net.params_flat().detach().cpu().numpy()
                          .tobytes()).hexdigest()


def counts():
    return dict(fa.KERNEL_LAUNCHES)


res = {"rank": rank}
if part == "probe":
    # what this build's gloo carries on CUDA tensors: each collective in
    # a group of its own (an unsupported one can leave its pair unusable),
    # a line per collective as it lands
    import datetime
    initialize_distributed(DistributedConfig(
        coordinator_address=coord, num_processes=2, process_id=rank,
        local_rank=0, backend="gloo"), device_type="cuda")
    x = torch.full((4,), float(rank + 1), device="cuda")

    def all_reduce(g):
        y = x.clone()
        dist.all_reduce(y, group=g)
        return y.tolist() == [3.0] * 4

    def broadcast(g):
        y = x.clone()
        dist.broadcast(y, 0, group=g)
        return y.tolist() == [1.0] * 4

    def all_gather(g):
        ys = [torch.empty(4, device="cuda") for _ in range(2)]
        dist.all_gather(ys, x.clone(), group=g)
        return [y.tolist() for y in ys] == [[1.0] * 4, [2.0] * 4]

    def send_recv(g):
        if rank == 0:
            dist.send(x.clone(), 1, group=g)
            return True
        y = torch.empty(4, device="cuda")
        dist.recv(y, 0, group=g)
        return y.tolist() == [1.0] * 4

    def all_gather_into_tensor(g):
        y = torch.empty(8, device="cuda")
        dist.all_gather_into_tensor(y, x.clone(), group=g)
        return y.tolist() == [1.0] * 4 + [2.0] * 4

    def reduce_scatter_tensor(g):
        y = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(y, x.clone(), group=g)
        return y.tolist() == [3.0] * 2

    # send/recv last: on CUDA tensors it can break the transport for
    # what follows (a device pointer written as host memory)
    ops = {f.__name__: f for f in (
        all_reduce, broadcast, all_gather, all_gather_into_tensor,
        reduce_scatter_tensor, send_recv)}
    for name, op in ops.items():
        g = dist.new_group([0, 1],
                           timeout=datetime.timedelta(seconds=20))
        try:
            right = op(g)
            torch.cuda.synchronize()
            verdict = "ok" if right else "ran, wrong values"
        except Exception as e:
            verdict = f"{type(e).__name__}: {str(e)[:160]}"
        print("PAR_PROBE " + json.dumps({name: verdict}), flush=True)
        dist.barrier()
    shutdown_distributed()
elif part == "b":
    initialize_distributed(DistributedConfig(
        coordinator_address=coord, num_processes=2, process_id=rank,
        local_rank=0, backend="gloo"), device_type="cuda")
    res["backend"] = str(dist.get_backend())
    # the all-reduce of the LM's f32 gradient, through host memory
    flat = torch.randn(int(os.environ["PAR_GRAD_FLOATS"]), device="cuda")
    for _ in range(2):
        dist.all_reduce(flat)
    torch.cuda.synchronize()
    ms = []
    for _ in range(5):
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_reduce(flat)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    res["all_reduce_ms"] = ms
    del flat
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import (
        ParallelWrapper, ShardingPlan)
    from deeplearning4j_tpu_torch.util.params import params_to_flat
    # the data group's summed gradient of the first global batch
    net = load_model(lm_zip, device="cuda")
    net._engage_plan(ShardingPlan())
    loss, grads, _, _ = net._grad_struct(
        net._batch_struct(DataSet(X[:4], Y[:4])), None)
    grads, loss = net._plan_rt.reduce_grads(grads, loss)
    np.save(os.path.join(out, f"grad_{rank}.npy"),
            params_to_flat(grads).detach().cpu().numpy())
    res["grad_loss"] = float(loss)
    net._engage_plan(None)
    del net, grads
    # SYNC: global batch 4, 2 a rank, 4 steps
    for k in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[k] = 0
    net = load_model(lm_zip, device="cuda")
    w = ParallelWrapper(net)
    res["sync_workers"] = w.n_workers

    class FirstStep:
        def on_epoch_start(self, n, e):
            pass

        def on_epoch_end(self, n, e):
            pass

        def iteration_done(self, n, it, ep, score, etl, bs):
            if it == 0:
                np.save(os.path.join(out, f"sync1_{rank}.npy"),
                        n.params_flat().detach().cpu().numpy())

    net.set_listeners(FirstStep())
    t0 = time.perf_counter()
    w.fit(ArrayDataSetIterator(X, Y, batch_size=4), epochs=1)
    torch.cuda.synchronize()
    res["sync_s"] = time.perf_counter() - t0
    res["sync_syncs"] = net._plan_syncs
    res["sync_launches"] = counts()
    res["sync_iterations"] = net.iteration_count
    res["sync_score"] = net.score()
    np.save(os.path.join(out, f"sync_{rank}.npy"),
            net.params_flat().detach().cpu().numpy())
    # AVERAGING: frequency 2, optimizer state averaged too
    del net, w
    torch.cuda.empty_cache()
    for k in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[k] = 0
    net = load_model(lm_zip, device="cuda")
    w = ParallelWrapper(net, mode="averaging", averaging_frequency=2,
                        average_updaters=True)
    seen = {}

    class AfterAverage:
        def on_epoch_start(self, n, e):
            pass

        def on_epoch_end(self, n, e):
            pass

        def iteration_done(self, n, it, ep, score, etl, bs):
            if (it + 1) % 2 == 0:
                seen[str(it + 1)] = digest(n)

    net.set_listeners(AfterAverage())
    w.fit(ArrayDataSetIterator(X, Y, batch_size=4), epochs=1)
    res["avg_launches"] = counts()
    res["avg_digests"] = seen
    res["avg_syncs"] = w.syncs
    res["avg_final"] = digest(net)
    shutdown_distributed()
elif part == "d":
    from deeplearning4j_tpu_torch.parallel import (
        SharedGradientsTrainer, SocketTransport)
    for k in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[k] = 0
    net = load_model(lm_zip, device="cuda")
    with SocketTransport(rank=rank, n_workers=2,
                         base_port=int(port)) as transport:
        trainer = SharedGradientsTrainer(net, n_workers=2, threshold=1e-4,
                                         rank=rank, transport=transport)
        t0 = time.perf_counter()
        trainer.fit(ArrayDataSetIterator(X, Y, batch_size=4), epochs=1,
                    batch_size=4)
        torch.cuda.synchronize()
        res.update({
            "seconds": time.perf_counter() - t0,
            "iterations": trainer.iteration_count,
            "compression_ratio": trainer.compression_ratio(),
            "sparsity": trainer.sparsity(),
            "bytes_sent": transport.bytes_sent,
            "messages_sent": transport.messages_sent,
            "score": net.score(), "launches": counts(),
            "digest": digest(net)})
print("PAR_RESULT " + json.dumps(res), flush=True)
'''


def _par_ranks(part, lm_zip, tokens, tmp, timeout=400, script=None):
    """`script`'s (default PAR_SCRIPT) `part` as ranks 0 and 1 in two
    processes on the card: each rank's result record."""
    import os
    from deeplearning4j_tpu_torch.parallel.distributed import free_port
    coord = f"127.0.0.1:{free_port()}"
    base = _two_free_ports()
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.abspath(
        __file__)), PAR_GRAD_FLOATS=str(PAR_GRAD_FLOATS))
    env.pop("DL4J_CUDA_FAULTS", None)
    # each rank writes to files: a full pipe would stall a rank inside a
    # collective while its peer waits on it
    logs = [(open(os.path.join(tmp, f"par_{part}_{r}.out"), "w+"),
             open(os.path.join(tmp, f"par_{part}_{r}.err"), "w+"))
            for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", script or PAR_SCRIPT, part, str(r), coord,
         lm_zip, tokens, tmp, str(base)], stdout=logs[r][0],
        stderr=logs[r][1],
        text=True, env=env) for r in range(2)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        # until both end, one fails (its peer would wait on it to the
        # group's timeout) or the deadline passes
        while any(p.poll() is None for p in procs) \
                and not any(p.poll() for p in procs) \
                and time.monotonic() < deadline:
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for p, (out_f, err_f) in zip(procs, logs):
            out_f.seek(0)
            err_f.seek(0)
            outs.append((p.returncode, out_f.read(), err_f.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in (f for pair in logs for f in pair):
            f.close()
    results = []
    for code, out, err in outs:
        if part == "probe":
            results.append({k: v for ln in out.splitlines()
                            if ln.startswith("PAR_PROBE ")
                            for k, v in json.loads(ln[10:]).items()})
            continue
        line = next((ln for ln in out.splitlines()
                     if ln.startswith("PAR_RESULT ")), None)
        if code != 0 or line is None:
            first = min(outs, key=lambda o: o[0] in (0, -9))
            raise AssertionError(
                f"parallel ({part}) ranks exited "
                f"{[o[0] for o in outs]}: {first[2][-2500:]}")
        results.append(json.loads(line[len("PAR_RESULT "):]))
    return results


def _two_free_ports() -> int:
    """A port p with p and p + 1 free (SocketTransport binds base + rank)."""
    import socket
    from deeplearning4j_tpu_torch.parallel.distributed import free_port
    for _ in range(50):
        p = free_port()
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            try:
                s.bind(("127.0.0.1", p + 1))
            except OSError:
                continue
        return p
    raise RuntimeError("no two adjacent free ports")


def _flat_of(zip_path):
    from deeplearning4j_tpu_torch.util.serialization import load_model
    return load_model(zip_path, device="cpu").params_flat()


def _par_paired_ms(lm_zip, batches, plan, pairs):
    """CUDA-event ms of the plain train step and the plan's (engaged on a
    one-rank group), in `pairs` interleaved pairs on two networks from
    one zip: pair i times both on batch i, the order alternating.
    Returns (plain ms, plan ms, the plan's collectives)."""
    from deeplearning4j_tpu_torch.util.serialization import load_model
    nets = [load_model(lm_zip), load_model(lm_zip)]
    gens = [torch.Generator(device="cuda").manual_seed(0) for _ in nets]
    nets[1]._engage_plan(plan)

    def step(k, ds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = nets[k]._train_step(ds, gens[k])
        end.record()
        float(loss)
        return start.elapsed_time(end)
    try:
        for k in (0, 1):
            step(k, batches[0])
        ms = ([], [])
        for i in range(pairs):
            ds = batches[i % len(batches)]
            for k in ((0, 1) if i % 2 == 0 else (1, 0)):
                ms[k].append(step(k, ds))
        syncs = nets[1]._plan_rt.syncs
    finally:
        nets[1]._engage_plan(None)
    return ms[0], ms[1], syncs


def parallel_cli(fa, tmp, lm_zip, tokens, features, labels):
    """Phase 15 (a) and (c): the train CLI's default `--mode sync` on a
    one-rank NCCL group against `--mode single`, and `--mesh
    data=1,zero=1|3`."""
    import os
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel import ShardingPlan
    from deeplearning4j_tpu_torch.parallel.distributed import (
        initialize_distributed, shutdown_distributed,
    )
    from deeplearning4j_tpu_torch.parallel.zero import (
        sharded_fraction, zero_spec,
    )
    from deeplearning4j_tpu_torch.util.serialization import load_model
    common = ["--model", lm_zip, "--dataset", tokens, "--epochs", "1",
              "--batch-size", str(TRAIN_BATCH), "--score-every", "1"]
    runs = {}
    for name, extra in (("single", ["--mode", "single"]),
                        ("sync", []),
                        ("zero1", ["--mesh", "data=1,zero=1"]),
                        ("zero3", ["--mesh", "data=1,zero=3"])):
        out = os.path.join(tmp, f"par_{name}.zip")
        t0 = time.perf_counter()
        code, stdout, stderr, launches = _cli_in_process(
            fa, common + ["--output", out] + extra)
        wall = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"parallel CLI {name}: exit {code}: "
                                 f"{stderr[-1500:]}")
        result = json.loads(stdout.strip().splitlines()[-1])
        record = None
        for line in reversed(stderr.strip().splitlines()):
            if line.startswith('{"parallel"'):
                record = json.loads(line)["parallel"]
                break
        if result["iterations"] != PAR_STEPS:
            raise AssertionError(f"parallel CLI {name} ran {result}")
        want = N_LAYERS * PAR_STEPS
        if any(launches[k] != want for k in KERNELS):
            raise AssertionError(f"parallel CLI {name}: launches "
                                 f"{launches} != {want} per kernel")
        if name != "single" and (record is None or record["world"] != 1
                                 or record["backend"] != "nccl"
                                 or record["syncs"] != PAR_STEPS):
            raise AssertionError(f"parallel CLI {name}: record {record}")
        runs[name] = {"wall_s": wall, "final_score": result["final_score"],
                      "launches": launches, "record": record,
                      "flat": _flat_of(out)}
    # (a) sync over one rank is the plain fit, bitwise; (c) so are the
    # ZeRO stages over one rank (nothing splits)
    for name in ("sync", "zero1", "zero3"):
        diff = (runs[name]["flat"] - runs["single"]["flat"]).abs().max()
        runs[name]["max_abs_diff_vs_single"] = float(diff)
        if float(diff) != 0.0:
            raise AssertionError(f"{name} differs from single by {diff}")
    # step ms on the card: the plain step and the plan's step (its
    # one-rank NCCL all-reduce of the gradients and loss), paired
    batches = [DataSet(features[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH],
                       labels[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH])
               for i in range(PAR_SEQS // TRAIN_BATCH)]
    net = load_model(lm_zip)
    initialize_distributed(device_type="cuda", single=True)
    try:
        plan = ShardingPlan()
        plain_ms, sync_ms, syncs = _par_paired_ms(lm_zip, batches, plan,
                                                  PAR_STEP_PAIRS)
        plan_desc = plan.describe()
        fraction_data1 = sharded_fraction(net.params, plan.mesh())
    finally:
        shutdown_distributed()
    diffs = sorted(b - a for a, b in zip(plain_ms, sync_ms))
    q1, _, q3 = statistics.quantiles(diffs, n=4)
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    nbytes = sharded = 0
    for _, leaf in iter_leaves(net.params):
        b = leaf.numel() * leaf.element_size()
        nbytes += b
        sharded += b if zero_spec(leaf, 2) else 0
    for r in runs.values():
        del r["flat"]
    return {"runs": runs, "plan": plan_desc,
            "step_ms_p50": {"single": statistics.median(plain_ms),
                            "sync": statistics.median(sync_ms)},
            "step_ms": {"single": plain_ms, "sync": sync_ms},
            "sync_minus_single_ms": {
                "pairs": len(diffs), "median": statistics.median(diffs),
                "q1": q1, "q3": q3, "min": diffs[0], "max": diffs[-1]},
            "syncs_per_step": syncs / (PAR_STEP_PAIRS + 1),
            "sharded_fraction_data1": fraction_data1,
            "sharded_fraction_at_data2": sharded / nbytes}


def parallel_two_ranks(fa, tmp, lm_zip, features, labels):
    """Phase 15 (b): SYNC and AVERAGING over two ranks on the one card
    (gloo through host memory), against one rank and a by-hand
    emulation."""
    import hashlib
    import os
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    from deeplearning4j_tpu_torch.util.serialization import load_model
    tokens = os.path.join(tmp, "par_rank_tokens.npz")
    np.savez(tokens, features=features[:PAR_RANK_SEQS],
             labels=labels[:PAR_RANK_SEQS])
    probes = _par_ranks("probe", lm_zip, tokens, tmp, timeout=90)
    gloo_cuda = {}
    for name in ("all_reduce", "broadcast", "all_gather",
                 "all_gather_into_tensor", "reduce_scatter_tensor",
                 "send_recv"):
        verdicts = [p.get(name, "no answer (hung or crashed)")
                    for p in probes]
        gloo_cuda[name] = next((v for v in verdicts if v != "ok"), "ok")
    if gloo_cuda["all_reduce"] != "ok":
        raise AssertionError(f"gloo all_reduce on CUDA tensors: "
                             f"{gloo_cuda['all_reduce']}")
    ranks = _par_ranks("b", lm_zip, tokens, tmp)
    for r in ranks:
        if r["sync_iterations"] != PAR_RANK_STEPS or r["sync_workers"] != 2:
            raise AssertionError(f"two-rank SYNC ran {r}")
    a, b = (np.load(os.path.join(tmp, f"sync_{i}.npy")) for i in (0, 1))
    if not np.array_equal(a, b):
        raise AssertionError("SYNC ranks' parameters differ")
    # the first batch's gradient: the two ranks' sum against one rank's,
    # leaf by leaf
    g0, g1 = (np.load(os.path.join(tmp, f"grad_{i}.npy")) for i in (0, 1))
    if not np.array_equal(g0, g1):
        raise AssertionError("the ranks' reduced gradients differ")
    one = load_model(lm_zip)
    one_loss, one_grads, _ = one.compute_gradient_and_score(
        DataSet(features[:TRAIN_BATCH], labels[:TRAIN_BATCH]))
    from deeplearning4j_tpu_torch.util.params import flat_to_params
    g_one = _cpu_tree(one_grads)
    del one_grads
    grads = _leaf_table(flat_to_params(torch.from_numpy(g0), g_one), g_one)
    loss_err = abs(ranks[0]["grad_loss"] - float(one_loss)) \
        / abs(float(one_loss))
    worst_g = max(grads, key=lambda p: grads[p]["err"])
    if not (grads[worst_g]["err"] <= PAR_GRAD_TOL
            and loss_err <= PAR_GRAD_TOL):
        raise AssertionError(f"two-rank gradient vs one rank: leaf "
                             f"{worst_g} {grads[worst_g]}, loss {loss_err}")
    # one process that sums the two halves' gradients (each rank's loss is
    # scaled by its share, 1/2, an exact factor): bitwise the two ranks,
    # after the first step and after the fourth
    from deeplearning4j_tpu_torch.nn.updaters import tree_map
    sync1 = np.load(os.path.join(tmp, "sync1_0.npy"))
    emu = load_model(lm_zip)
    for i in range(PAR_RANK_STEPS):
        halves = []
        for r in range(2):
            lo = i * TRAIN_BATCH + r * TRAIN_BATCH // 2
            sl = slice(lo, lo + TRAIN_BATCH // 2)
            halves.append(emu.compute_gradient_and_score(
                DataSet(features[sl], labels[sl]))[1])
        emu._update(tree_map(lambda x, y: x * 0.5 + y * 0.5, *halves))
        del halves
        if i in (0, PAR_RANK_STEPS - 1) and not np.array_equal(
                emu.params_flat().detach().cpu().numpy(),
                sync1 if i == 0 else a):
            raise AssertionError(f"two-rank SYNC after step {i + 1} is not "
                                 "bitwise the summed halves' emulation")
    del emu
    # the one-rank batch-4 run of the same steps, leaf by leaf against
    # each leaf's own update
    before = {p: t.detach().cpu().clone() for p, t in iter_leaves(one.params)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    tables = {}
    for i in range(PAR_RANK_STEPS):
        sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        one._train_step(DataSet(features[sl], labels[sl]), gen)
        if i in (0, PAR_RANK_STEPS - 1):
            one_tree = _cpu_tree(one.params)
            tables[i + 1] = _leaf_table(
                flat_to_params(torch.from_numpy(sync1 if i == 0 else a),
                               one_tree), one_tree, before, g_one)
    worst = {}
    for steps, tol in ((1, PAR_UPDATE_TOL), (PAR_RANK_STEPS, PAR_DRIFT_TOL)):
        t = tables[steps]
        leaf = max(t, key=lambda p: t[p]["err"])
        cond = max(t, key=lambda p: t[p]["err_conditioned"])
        worst[steps] = {"leaf": {"leaf": leaf, **t[leaf]},
                        "conditioned": {"leaf": cond, **t[cond]}}
        if not t[cond]["err_conditioned"] <= tol:
            raise AssertionError(
                f"two-rank SYNC vs one rank after {steps} steps: leaf "
                f"{cond} {t[cond]} of its update")
    del one
    # AVERAGING emulated in one process: two networks step their halves,
    # averaged by hand (f32 mean) after steps 2 and 4
    nets = [load_model(lm_zip) for _ in range(2)]
    gens = [torch.Generator(device="cuda").manual_seed(s) for s in (1, 2)]
    want = {}
    for i in range(PAR_RANK_STEPS):
        for r, net in enumerate(nets):
            lo = i * TRAIN_BATCH + r * TRAIN_BATCH // 2
            sl = slice(lo, lo + TRAIN_BATCH // 2)
            net._train_step(DataSet(features[sl], labels[sl]), gens[r])
        if (i + 1) % 2 == 0:
            _average_by_hand(nets)
            want[str(i + 1)] = hashlib.sha256(
                nets[0].params_flat().detach().cpu().numpy().tobytes()
            ).hexdigest()
    for r in ranks:
        if r["avg_digests"] != want:
            raise AssertionError(f"AVERAGING rank {r['rank']} after each "
                                 f"average {r['avg_digests']} != the "
                                 f"emulation's {want}")
    del nets
    torch.cuda.empty_cache()
    launches = {k: sum(r["sync_launches"][k] + r["avg_launches"][k]
                       for r in ranks) for k in KERNELS}
    want_launches = 2 * 2 * N_LAYERS * PAR_RANK_STEPS
    if any(launches[k] != want_launches for k in KERNELS):
        raise AssertionError(f"two-rank launches {launches} != "
                             f"{want_launches}")
    ar = sorted(ms for r in ranks for ms in r["all_reduce_ms"])
    return {"gloo_cuda": gloo_cuda,
            "backend": ranks[0]["backend"],
            "all_reduce_ms_p50": statistics.median(ar),
            "all_reduce_ms": ar,
            "all_reduce_bytes": PAR_GRAD_FLOATS * 4,
            "all_reduce_note": "gloo through host memory, two ranks on "
                               "one card; not a multi-GPU number",
            "sync_s": [r["sync_s"] for r in ranks],
            "sync_syncs": [r["sync_syncs"] for r in ranks],
            "grad_worst_leaf": {"leaf": worst_g, **grads[worst_g]},
            "grad_total_norm": math.sqrt(sum(r["norm"] ** 2
                                             for r in grads.values())),
            "loss_err_vs_one_rank": loss_err,
            "update_worst_after_1": worst[1],
            f"update_worst_after_{PAR_RANK_STEPS}": worst[PAR_RANK_STEPS],
            "sync_bitwise_summed_halves": True,
            "grad_by_leaf": grads,
            f"update_by_leaf_after_{PAR_RANK_STEPS}":
                tables[PAR_RANK_STEPS],
            "avg_syncs": [r["avg_syncs"] for r in ranks],
            "avg_digests_equal_emulation": True,
            "launches": launches}


def _leaf_table(a_tree, b_tree, before=None, grads=None, ulps=0):
    """Per leaf of two trees on the CPU: ||a - b|| over ||b|| ("err"),
    or, with `before` (b's leaves before its steps), over the leaf's
    update ||b - before||; the norm it is measured against ("norm") and
    the largest element error ("max_abs"). With `grads` (the first
    step's gradient) also the same ratio over the elements whose first
    gradient is at least PAR_CONDITIONED_GRAD ("err_conditioned", of
    "conditioned" elements) and the |gradient| of the worst element.
    With `ulps`, "err_conditioned" counts each element's |a - b| only
    beyond `ulps` f32 ulps of b ("err_conditioned_raw" without that
    floor)."""
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    b_leaves = dict(iter_leaves(b_tree))
    g_leaves = dict(iter_leaves(grads)) if grads is not None else {}

    def ratio(diff, ref):
        norm = float(ref.norm())
        if norm:
            return float(diff.norm()) / norm, norm
        return (math.inf if diff.numel() and float(diff.abs().max())
                else 0.0), norm
    table = {}
    for path, a in iter_leaves(a_tree):
        b = b_leaves[path]
        ref = b if before is None else b - before[path]
        diff = a - b
        err, norm = ratio(diff, ref)
        row = {"err": err, "norm": norm,
               "max_abs": float(diff.abs().max())}
        if path in g_leaves:
            g = g_leaves[path].abs()
            keep = g >= PAR_CONDITIONED_GRAD
            row["err_conditioned"] = ratio(diff[keep], ref[keep])[0]
            if ulps:
                ulp = torch.nextafter(b.abs(), torch.full_like(b, math.inf)) \
                    - b.abs()
                row["err_conditioned_raw"] = row["err_conditioned"]
                row["err_conditioned"] = ratio(
                    (diff.abs() - ulps * ulp).clamp_min(0)[keep],
                    ref[keep])[0]
            row["conditioned"] = int(keep.sum())
            row["elements"] = g.numel()
            row["grad_at_max"] = float(
                g.reshape(-1)[diff.abs().argmax()])
        table["/".join(path)] = row
    return table


def _cpu_tree(tree):
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _average_by_hand(nets):
    """The f32 mean of two networks' parameters, floating optimizer state
    and layer state, written into both."""
    from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
    with torch.no_grad():
        for kind in (lambda n: tree_leaves(n.params),
                     lambda n: [t for t in tree_leaves(n.state)
                                if t.is_floating_point()],
                     lambda n: [t for t in tree_leaves(n.opt_state)
                                if t.is_floating_point()]):
            for a, b in zip(kind(nets[0]), kind(nets[1])):
                m = ((a.float() + b.float()) / 2).to(a.dtype)
                a.copy_(m)
                b.copy_(m)


def parallel_shared(fa, tmp):
    """Phase 15 (d): SharedGradientsTrainer across two processes over
    SocketTransport, the LM at depth 1, gradients encoded on the card."""
    import os
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.registry import parse_zoo_source
    from deeplearning4j_tpu_torch.util.serialization import save_model
    name, kw = parse_zoo_source(LM_SOURCE[len("zoo:"):])
    lm1 = os.path.join(tmp, "lm_depth1.zip")
    save_model(model_by_name(name, **{**kw, "n_layers": 1}).init(), lm1,
               compression=STORED)
    tokens = os.path.join(tmp, "par_rank_tokens.npz")
    ranks = _par_ranks("d", lm1, tokens, tmp)
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError("shared-gradient replicas differ")
    steps = PAR_RANK_STEPS
    for r in ranks:
        if r["iterations"] != steps or any(
                r["launches"][k] != steps for k in KERNELS):
            raise AssertionError(f"shared-gradient rank ran {r}")
    return {"ranks": [{k: r[k] for k in ("seconds", "compression_ratio",
                                         "sparsity", "bytes_sent",
                                         "messages_sent", "score")}
                      for r in ranks],
            "bytes_sent_per_step": [r["bytes_sent"] / steps for r in ranks],
            "replicas_bitwise": True,
            "launches": {k: sum(r["launches"][k] for r in ranks)
                         for k in KERNELS}}


def parallel(fa, tmp):
    """Phase 15: data-parallel training of the full-width LM."""
    import os
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.registry import parse_zoo_source
    from deeplearning4j_tpu_torch.util.serialization import save_model
    t_phase = time.perf_counter()
    name, kw = parse_zoo_source(LM_SOURCE[len("zoo:"):])
    lm_zip, tokens = os.path.join(tmp, "lm.zip"), os.path.join(tmp, "t.npz")
    save_model(model_by_name(name, **kw).init(), lm_zip, compression=STORED)
    rs = np.random.RandomState(1515)
    _write_token_set(tokens, rs, PAR_SEQS)
    with np.load(tokens) as d:
        features, labels = d["features"], d["labels"]
    t0 = time.perf_counter()
    cli_part = parallel_cli(fa, tmp, lm_zip, tokens, features, labels)
    cli_part["seconds"] = time.perf_counter() - t0
    emit({"phase": "parallel_cli", **cli_part})
    t0 = time.perf_counter()
    ranks_part = parallel_two_ranks(fa, tmp, lm_zip, features, labels)
    ranks_part["seconds"] = time.perf_counter() - t0
    emit({"phase": "parallel_two_ranks", **ranks_part})
    t0 = time.perf_counter()
    shared_part = parallel_shared(fa, tmp)
    shared_part["seconds"] = time.perf_counter() - t0
    emit({"phase": "parallel_shared", **shared_part})
    launches = {k: sum(cli_part["runs"][r]["launches"][k]
                       for r in ("sync", "zero1", "zero3"))
                + ranks_part["launches"][k] + shared_part["launches"][k]
                for k in KERNELS}
    want = 3 * N_LAYERS * PAR_STEPS + 4 * N_LAYERS * PAR_RANK_STEPS \
        + 2 * PAR_RANK_STEPS
    if any(launches[k] != want for k in KERNELS):
        raise AssertionError(f"parallel launches {launches} != {want}")
    row = {"phase": "parallel", "seconds": time.perf_counter() - t_phase,
           "flash_launches": launches}
    emit(row)
    return row


# ------------------------------------------------------- phase 16: sequence
# (a) the ring at the LM's attention shape over seq=2; (b) and (c) 4 steps
# of global batch 4 (the LM's TRAIN_BATCH), each rank 1024 steps of each
# sequence in (b), 2 of the 4 blocks in (c) over 4 microbatches of 1
SEQ_RING_SHAPE = (4, SEQ, HEADS, HEAD_DIM)
SEQ_RING_TOL = 1e-4          # the kernel table's f32 atol; gradients of
#                              each tensor's largest entry
SEQ_STEPS, SEQ_MICROBATCHES = 4, 4
SEQ_RING_CALLS = 5           # timed ring calls a case
SEQ_BUDGET_S = 90.0
# phase 17 runs in phase 16's ranks: (a) 1 + TENSOR_PREDICT_CALLS timed
# predicts, (b) phase 16's 4 steps, (c) the MoE LM at depth 2 for 2 steps
TENSOR_PREDICT_CALLS = 3
TENSOR_PREDICT_TOL = 1e-5
TENSOR_MOE_LAYERS, TENSOR_MOE_STEPS = 2, 2
# (b) and (c)'s rounding floor: each element's difference from one
# process counts only beyond this many f32 ulps of the one-process value.
# At the zoo's AdamW 3e-4 one ulp of a layer-norm gamma just above 1.0
# (1.19e-7) is 1.75e-5 of its 512-element leaf's first update (3e-4 x
# sqrt(512)), so without the floor PAR_UPDATE_TOL cannot tell the stored
# value's rounding from an error
TENSOR_ROUNDING_ULPS = 1
TENSOR_BUDGET_S = 60.0
SEQ_SCRIPT = r"""
import contextlib, json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.data.iterator import ArrayDataSetIterator
from deeplearning4j_tpu_torch.nn.layers.attention import (
    dot_product_attention)
from deeplearning4j_tpu_torch.parallel import (
    ContextParallelTrainer, MeshConfig, PipelineParallelTrainer, build_mesh)
from deeplearning4j_tpu_torch.parallel import ring as R
from deeplearning4j_tpu_torch.parallel.distributed import (
    DistributedConfig, initialize_distributed, shutdown_distributed)
from deeplearning4j_tpu_torch.util.platform import set_f32_matmul_exact
from deeplearning4j_tpu_torch.util.serialization import load_model

part, rank, coord, lm_zip, tokens, out, port = sys.argv[1:8]
rank = int(rank)
cfg = json.loads(os.environ["SEQ_CONFIG"])
set_f32_matmul_exact()
initialize_distributed(DistributedConfig(
    coordinator_address=coord, num_processes=2, process_id=rank,
    local_rank=0, backend="gloo"), device_type="cuda")
res = {"rank": rank, "backend": str(dist.get_backend())}


def zero():
    for k in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[k] = 0


def counts():
    return dict(fa.KERNEL_LAUNCHES)


def timed(fn, n):
    ms = []
    for _ in range(n):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[len(ms) // 2]


# (a) the flash ring against the card's dense attention of the whole
# sequence
mesh = build_mesh(MeshConfig(data=1, seq=2))
ring = R.Ring.of(mesh)
B, T, H, D = cfg["shape"]
g = torch.Generator(device="cuda").manual_seed(1616)
q, k, v, w = (torch.randn(B, T, H, D, generator=g, device="cuda")
              for _ in range(4))
mask = (torch.rand(B, T, generator=g, device="cuda") > 0.2).float()
mask[1, T // 2:] = 0.0          # rank 1's whole shard of row 1
tl = T // 2
sl = slice(rank * tl, (rank + 1) * tl)
ring_rows = {}
for case, causal, m in (("causal", True, None), ("masked", False, mask)):
    qd, kd, vd = (x.clone().requires_grad_() for x in (q, k, v))
    ref = dot_product_attention(qd, kd, vd, mask=m, causal=causal)
    rg = torch.autograd.grad((ref * w).sum(), (qd, kd, vd))
    ref = ref.detach()[:, sl]
    del qd, kd, vd
    ql, kl, vl = (x[:, sl].clone().requires_grad_() for x in (q, k, v))
    ml = None if m is None else m[:, sl].contiguous()
    wl = w[:, sl]
    zero()
    R.reset_transfers()
    o = R.ring_flash_self_attention(ql, kl, vl, ring=ring, causal=causal,
                                    mask=ml)
    fwd_launches = counts()
    fwd_transfers = dict(R.TRANSFERS, routes=dict(R.TRANSFERS["routes"]))
    gl = torch.autograd.grad((o * wl).sum(), (ql, kl, vl))
    all_launches = counts()
    row = {"out_max_abs_err": float((o.detach() - ref).abs().max()),
           "grad_err_of_largest": {
               n: float((a - b[:, sl]).abs().max() / b.abs().max())
               for n, a, b in zip(("dq", "dk", "dv"), gl, rg)},
           "launches_forward": fwd_launches,
           "launches_forward_backward": all_launches,
           "rotation_bytes_forward": fwd_transfers["bytes"],
           "routes": fwd_transfers["routes"]}
    del rg, gl, ref

    def fwd():
        with torch.no_grad():
            R.ring_flash_self_attention(ql, kl, vl, ring=ring,
                                        causal=causal, mask=ml)

    def fwd_bwd():
        o2 = R.ring_flash_self_attention(ql, kl, vl, ring=ring,
                                         causal=causal, mask=ml)
        torch.autograd.grad((o2 * wl).sum(), (ql, kl, vl))

    R.reset_transfers()
    row["forward_ms"] = timed(fwd, cfg["calls"])
    shifts = R.TRANSFERS["shifts"]
    row["rotation_ms"] = 1e3 * R.TRANSFERS["seconds"] / max(shifts, 1)
    row["rotation_bytes"] = R.TRANSFERS["bytes"] / max(shifts, 1)
    row["forward_backward_ms"] = timed(fwd_bwd, cfg["calls"])
    ring_rows[case] = row
res["ring"] = ring_rows
del q, k, v, w, mask
torch.cuda.empty_cache()
data = np.load(tokens)
X, Y = data["features"], data["labels"]


class Steps:
    def __init__(self, name):
        self.name, self.t = name, [time.perf_counter()]

    def on_epoch_start(self, n, e):
        pass

    def on_epoch_end(self, n, e):
        pass

    def iteration_done(self, n, it, ep, score, etl, bs):
        self.t.append(time.perf_counter())
        rt = getattr(n, "_plan_rt", None)
        if rt is not None:
            # the model group's collectives since the fit engaged the plan
            self.collectives = dict(rt.model_collectives)
        if it == 0:
            # under a plan the network holds pieces: whole them (on
            # every rank at once) to save
            with (rt.whole_view(n) if rt is not None
                  else contextlib.nullcontext()):
                np.save(os.path.join(out, f"{self.name}1_{rank}.npy"),
                        n.params_flat().detach().cpu().numpy())


def train(name, make, path=None, n=None):
    net = load_model(path or lm_zip, device="cuda")
    steps = Steps(name)
    net.set_listeners(steps)
    trainer = make(net)
    zero()
    R.reset_transfers()
    dist.barrier()
    steps.t = [time.perf_counter()]
    trainer.fit(ArrayDataSetIterator(X[:n], Y[:n], batch_size=cfg["batch"]),
                epochs=1, batch_size=cfg["batch"])
    torch.cuda.synchronize()
    np.save(os.path.join(out, f"{name}_{rank}.npy"),
            net.params_flat().detach().cpu().numpy())
    ms = [(b - a) * 1e3 for a, b in zip(steps.t, steps.t[1:])]
    return {"iterations": net.iteration_count, "score": net.score(),
            "step_ms": ms, "step_ms_p50": sorted(ms)[len(ms) // 2],
            "launches": counts(), "syncs": trainer.syncs,
            "collectives": getattr(steps, "collectives", None),
            "rotation": {"shifts": R.TRANSFERS["shifts"],
                         "bytes": R.TRANSFERS["bytes"],
                         "seconds": R.TRANSFERS["seconds"],
                         "routes": dict(R.TRANSFERS["routes"])}}


res["context"] = train("cp", lambda net: ContextParallelTrainer(
    net, build_mesh(MeshConfig(data=1, seq=2))))
torch.cuda.empty_cache()
res["pipeline"] = train("pp", lambda net: PipelineParallelTrainer(
    net, build_mesh(MeshConfig(data=1, stage=2)),
    n_microbatches=cfg["microbatches"]))
torch.cuda.empty_cache()

# phase 17 (tensor): data=1, model=2 under the LM's Megatron rules
from deeplearning4j_tpu_torch.models.transformer import TransformerLM
from deeplearning4j_tpu_torch.monitor import xla as ledger
from deeplearning4j_tpu_torch.nn.updaters import tree_leaves
from deeplearning4j_tpu_torch.parallel import ParallelInference, ShardingPlan
t_tensor = time.perf_counter()
plan = ShardingPlan(data=1, model=2, rules=TransformerLM.sharding_rules())
tres = {}
base = torch.cuda.memory_allocated()
net = load_model(lm_zip, device="cuda")
pi = ParallelInference(net, plan=plan, mode="sequential")
tres["param_bytes"] = sum(t.numel() * t.element_size()
                          for t in tree_leaves(net.params))
xp = X[:cfg["batch"]]
zero()
np.save(os.path.join(out, f"tp_pred_{rank}.npy"), pi.output(xp))
tres["predict_launches"] = counts()
tres["predict_collectives"] = dict(net._plan_rt.model_collectives)
tres["predict_ms"] = timed(lambda: pi.output(xp), cfg["tensor_calls"])
pi.shutdown()
del pi, net
torch.cuda.empty_cache()


class PlanFit:
    # the fit under the plan, per call (gloo's collectives cannot be
    # captured), the program ledger counting its first step
    def __init__(self, net):
        self.net, self.syncs = net, 0

    def fit(self, it, epochs, batch_size):
        ledger.clear_ledger()
        ledger.enable_ledger()
        torch.cuda.reset_peak_memory_stats()
        try:
            self.net.fit(it, epochs=epochs, plan=plan, scan_steps=1)
        finally:
            ledger.disable_ledger()
        self.syncs = self.net._plan_syncs
        self.flops = [r.flops for r in ledger.records()
                      if r.name == "mln/train_step"]
        self.peak = torch.cuda.max_memory_allocated() - base


for key, tag, path, n in (("train", "tp", lm_zip, None),
                          ("moe", "tpmoe", cfg["moe_zip"],
                           cfg["moe_steps"] * cfg["batch"])):
    fits = []
    tres[key] = train(tag, lambda net: fits.append(PlanFit(net))
                      or fits[-1], path=path, n=n)
    tres[key].update(flops=fits[0].flops, peak_bytes=fits[0].peak)
    torch.cuda.empty_cache()
tres["seconds"] = time.perf_counter() - t_tensor
res["tensor"] = tres
shutdown_distributed()
print("PAR_RESULT " + json.dumps(res), flush=True)
"""


def _seq_one_process(lm_zip, features, labels, steps=SEQ_STEPS):
    """The one-process fit of the same batches on the card: its first
    gradient, and its parameters after step 1 and after the last step
    (CPU trees), the parameters before, and the peak bytes the fit
    allocated."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.updaters import tree_map
    from deeplearning4j_tpu_torch.util.params import iter_leaves
    from deeplearning4j_tpu_torch.util.serialization import load_model
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    one = load_model(lm_zip)
    _, grads, _ = one.compute_gradient_and_score(
        DataSet(features[:TRAIN_BATCH], labels[:TRAIN_BATCH]))
    g_one = _cpu_tree(grads)
    del grads
    before = {p: t.detach().cpu().clone() for p, t in iter_leaves(one.params)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    after = {}
    for i in range(steps):
        sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
        one._train_step(DataSet(features[sl], labels[sl]), gen)
        if i in (0, steps - 1):
            # copies: the steps update the parameters in place
            after[i + 1] = tree_map(lambda t: t.detach().cpu().clone(),
                                    one.params)
    peak = torch.cuda.max_memory_allocated() - base
    del one
    torch.cuda.empty_cache()
    return g_one, before, after, peak


def _seq_against_one(tmp, name, one, last=SEQ_STEPS, ulps=0):
    """(b)/(c)'s comparisons: the two ranks bitwise equal after step 1 and
    at the end, and each leaf within PAR_UPDATE_TOL of its update after
    step 1 (PAR_DRIFT_TOL after the last) over the conditioned elements
    (each element's difference beyond `ulps` ulps of its value,
    `_leaf_table`)."""
    import os
    from deeplearning4j_tpu_torch.util.params import flat_to_params
    g_one, before, after = one[:3]
    worst = {}
    for steps, tag, tol in ((1, f"{name}1", PAR_UPDATE_TOL),
                            (last, name, PAR_DRIFT_TOL)):
        a, b = (np.load(os.path.join(tmp, f"{tag}_{r}.npy")) for r in (0, 1))
        if not np.array_equal(a, b):
            raise AssertionError(f"{name} ranks' parameters differ after "
                                 f"{steps} steps")
        t = _leaf_table(flat_to_params(torch.from_numpy(a), after[steps]),
                        after[steps], before, g_one, ulps=ulps)
        leaf = max(t, key=lambda p: t[p]["err"])
        cond = max(t, key=lambda p: t[p]["err_conditioned"])
        worst[steps] = {"leaf": {"leaf": leaf, **t[leaf]},
                        "conditioned": {"leaf": cond, **t[cond]},
                        "tolerance": tol, "rounding_ulps": ulps}
        if ulps:
            raw = max(t, key=lambda p: t[p]["err_conditioned_raw"])
            worst[steps]["conditioned_raw"] = {"leaf": raw, **t[raw]}
        if not t[cond]["err_conditioned"] <= tol:
            raise AssertionError(
                f"{name} vs one process after {steps} steps: leaf {cond} "
                f"{t[cond]} of its update")
    return worst


def sequence(fa, tmp):
    """Phase 16: sequence and pipeline parallelism of the full-width LM
    over two gloo ranks on the card."""
    import os
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.registry import parse_zoo_source
    from deeplearning4j_tpu_torch.util.serialization import save_model
    t_phase = time.perf_counter()
    name, kw = parse_zoo_source(LM_SOURCE[len("zoo:"):])
    lm_zip, tokens = os.path.join(tmp, "lm.zip"), os.path.join(tmp, "t.npz")
    save_model(model_by_name(name, **kw).init(), lm_zip, compression=STORED)
    moe_zip = os.path.join(tmp, "moe.zip")
    save_model(model_by_name("TransformerLMMoE", **dict(
        kw, n_layers=TENSOR_MOE_LAYERS)).init(), moe_zip, compression=STORED)
    rs = np.random.RandomState(1616)
    _write_token_set(tokens, rs, SEQ_STEPS * TRAIN_BATCH)
    with np.load(tokens) as d:
        features, labels = d["features"], d["labels"]
    os.environ["SEQ_CONFIG"] = json.dumps({
        "shape": SEQ_RING_SHAPE, "calls": SEQ_RING_CALLS,
        "batch": TRAIN_BATCH, "microbatches": SEQ_MICROBATCHES,
        "moe_zip": moe_zip, "moe_steps": TENSOR_MOE_STEPS,
        "tensor_calls": TENSOR_PREDICT_CALLS})
    try:
        ranks = _par_ranks("seq", lm_zip, tokens, tmp, timeout=300,
                           script=SEQ_SCRIPT)
    finally:
        os.environ.pop("SEQ_CONFIG", None)
    ranks_s = time.perf_counter() - t_phase
    # (a) each rank's shard against the dense attention
    ring = {}
    for case in ("causal", "masked"):
        rows = [r["ring"][case] for r in ranks]
        err = max(x["out_max_abs_err"] for x in rows)
        gerr = {g: max(x["grad_err_of_largest"][g] for x in rows)
                for g in ("dq", "dk", "dv")}
        want = {"flash_fwd": 2, "flash_bwd_dq": 2, "flash_bwd_dkv": 2}
        for x in rows:
            if x["launches_forward"] != dict(want, flash_bwd_dq=0,
                                             flash_bwd_dkv=0) \
                    or x["launches_forward_backward"] != want:
                raise AssertionError(f"ring {case} launches {x}")
            if x["routes"] != {"gloo_host": 1}:
                raise AssertionError(f"ring {case} route {x['routes']}")
        if not (err <= SEQ_RING_TOL and max(gerr.values()) <= SEQ_RING_TOL):
            raise AssertionError(f"ring {case}: out {err}, grads {gerr}")
        ring[case] = {"out_max_abs_err": err, "grad_err_of_largest": gerr,
                      "launches_per_call": rows[0][
                          "launches_forward_backward"],
                      "forward_ms": [x["forward_ms"] for x in rows],
                      "forward_backward_ms": [x["forward_backward_ms"]
                                              for x in rows],
                      "rotation_ms": [x["rotation_ms"] for x in rows],
                      "rotation_bytes": rows[0]["rotation_bytes"],
                      "route": "gloo_host"}
    emit({"phase": "sequence_ring", "shape": list(SEQ_RING_SHAPE),
          "seq": 2, "dtype": "float32", **ring})
    one = _seq_one_process(lm_zip, features, labels)
    parts = {}
    per_step = {"context": {k: 2 * N_LAYERS for k in KERNELS},
                "pipeline": {k: (SEQ_MICROBATCHES + 1) * N_LAYERS // 2
                             for k in KERNELS}}
    for part, tag in (("context", "cp"), ("pipeline", "pp")):
        runs = [r[part] for r in ranks]
        for r in runs:
            if r["iterations"] != SEQ_STEPS or any(
                    r["launches"][k] != per_step[part][k] * SEQ_STEPS
                    for k in KERNELS):
                raise AssertionError(f"{part}: {r}")
        worst = _seq_against_one(tmp, tag, one)
        parts[part] = {
            "score": runs[0]["score"],
            "step_ms_p50": [r["step_ms_p50"] for r in runs],
            "step_ms": [r["step_ms"] for r in runs],
            "launches_per_step_and_rank": per_step[part],
            "launches": {k: sum(r["launches"][k] for r in runs)
                         for k in KERNELS},
            "gradient_syncs": [r["syncs"] for r in runs],
            "rotation": [r["rotation"] for r in runs],
            "ranks_bitwise_equal": True,
            "update_worst_after_1": worst[1],
            f"update_worst_after_{SEQ_STEPS}": worst[SEQ_STEPS]}
        emit({"phase": f"sequence_{part}", **parts[part]})
    # phase 17's part of the ranks' time is its own
    tensor_s = max(r["tensor"]["seconds"] for r in ranks)
    seconds = time.perf_counter() - t_phase - tensor_s
    row = {"phase": "sequence", "seconds": seconds,
           "ranks_s": ranks_s - tensor_s, "budget_s": SEQ_BUDGET_S,
           "flash_launches": {
               "sequence": {k: parts["context"]["launches"][k]
                            for k in KERNELS},
               "pipeline": parts["pipeline"]["launches"]}}
    emit(row)
    if seconds > SEQ_BUDGET_S:
        raise AssertionError(f"phase 16 took {seconds:.1f} s "
                             f"> {SEQ_BUDGET_S}")
    row["tensor"] = tensor(fa, tmp, [r["tensor"] for r in ranks], one,
                           lm_zip, moe_zip, features, labels, tensor_s)
    return row


def _tensor_flops(layers, model):
    """The LM's train step's FLOPs at batch TRAIN_BATCH on one rank of a
    `model`-way split (the ledger's rules: 6 x GEMM parameters x tokens,
    the flash kernels' 18 x D a live pair, head and head dim)."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    e = HEADS * HEAD_DIM
    gemm = 6 * (12 * e * e * layers // model + e * VOCAB) \
        * TRAIN_BATCH * SEQ
    flash = 18 * HEAD_DIM * fa.live_pairs(SEQ, SEQ, True) * TRAIN_BATCH \
        * (HEADS // model) * layers
    return gemm + flash


def tensor(fa, tmp, tr, one, lm_zip, moe_zip, features, labels,
           ranks_s):
    """Phase 17: tensor- and expert-parallel compute of the full-width LM
    at data=1,model=2, checked against one process on the card (the
    ranks ran in phase 16's processes; `tr` their records)."""
    import os
    from deeplearning4j_tpu_torch.util.serialization import load_model
    t_phase = time.perf_counter()
    # (a) predict
    net = load_model(lm_zip)
    want = net.output(features[:TRAIN_BATCH]).float().cpu().numpy()
    del net
    torch.cuda.empty_cache()
    preds = [np.load(os.path.join(tmp, f"tp_pred_{r}.npy")) for r in (0, 1)]
    if not np.array_equal(preds[0], preds[1]):
        raise AssertionError("tensor (a): the ranks' answers differ")
    err = float(np.abs(preds[0] - want).max())
    if not err <= TENSOR_PREDICT_TOL:
        raise AssertionError(f"tensor (a): {err} from one process")
    fwd_only = {"flash_fwd": N_LAYERS, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for t in tr:
        if t["predict_launches"] != fwd_only:
            raise AssertionError(f"tensor (a) launches {t}")
    # (b) train, (c) MoE: the counts, then the one-process comparisons
    one_moe = _seq_one_process(moe_zip, features, labels,
                               steps=TENSOR_MOE_STEPS)
    parts = {}
    for part, tag, layers, steps, ref in (
            ("train", "tp", N_LAYERS, SEQ_STEPS, one),
            ("moe", "tpmoe", TENSOR_MOE_LAYERS, TENSOR_MOE_STEPS, one_moe)):
        runs = [t[part] for t in tr]
        flops = _tensor_flops(layers, 2)
        for r in runs:
            if r["iterations"] != steps or any(
                    r["launches"][k] != layers * steps for k in KERNELS):
                raise AssertionError(f"tensor {part}: {r}")
            if part == "train" and r["flops"] != [flops]:
                raise AssertionError(f"tensor {part}: ledger FLOPs "
                                     f"{r['flops']}, analytic {flops}")
        worst = _seq_against_one(tmp, tag, ref, last=steps,
                                 ulps=TENSOR_ROUNDING_ULPS)
        c = runs[0]["collectives"]
        parts[part] = {
            "score": runs[0]["score"],
            "step_ms_p50": [r["step_ms_p50"] for r in runs],
            "step_ms": [r["step_ms"] for r in runs],
            "launches_per_step_and_rank": {k: layers for k in KERNELS},
            "launches": {k: sum(r["launches"][k] for r in runs)
                         for k in KERNELS},
            "collectives_per_step": c["calls"] / steps,
            "collective_ms_per_step": 1e3 * c["seconds"] / steps,
            "collective_bytes_per_step": c["bytes"] / steps,
            "plan_syncs": [r["syncs"] for r in runs],
            "ledger_flops_per_rank": runs[0]["flops"],
            "peak_bytes_per_rank": [r["peak_bytes"] for r in runs],
            "peak_bytes_one_process": ref[3],
            "ranks_bitwise_equal": True,
            "update_worst_after_1": worst[1],
            f"update_worst_after_{steps}": worst[steps]}
        if part == "train":
            whole = _tensor_flops(layers, 1)
            parts[part].update(analytic_flops_per_rank=flops,
                               one_process_flops=whole,
                               flops_share=flops / whole)
    del one_moe
    seconds = time.perf_counter() - t_phase + ranks_s
    row = {"phase": "tensor", "seconds": seconds, "ranks_s": ranks_s,
           "budget_s": TENSOR_BUDGET_S, "mesh": {"data": 1, "model": 2},
           "predict": {"max_abs_err": err, "ranks_bitwise_equal": True,
                       "launches_per_forward_and_rank": fwd_only,
                       "ms": [t["predict_ms"] for t in tr],
                       "collectives_per_forward":
                           tr[0]["predict_collectives"],
                       "param_bytes_per_rank": [t["param_bytes"]
                                                for t in tr],
                       "param_bytes_one_process": PAR_GRAD_FLOATS * 4},
           **parts,
           "flash_launches": {k: sum(t["predict_launches"][k]
                                     + t["train"]["launches"][k]
                                     + t["moe"]["launches"][k] for t in tr)
                              for k in KERNELS}}
    emit(row)
    if seconds > TENSOR_BUDGET_S:
        raise AssertionError(f"phase 17 took {seconds:.1f} s "
                             f"> {TENSOR_BUDGET_S}")
    return row


# ------------------------------------------------------------- phase 18: nlp
NLP_BUDGET_S = 45.0
NLP_VOCAB = 71290            # text8's word types at min_count=5
NLP_MIN_COUNT = 5
NLP_SENTENCE = 1000          # tokens a sentence
# the GoogleNews vectors' published width and the reference's batch
NLP_LAYER, NLP_WINDOW, NLP_NEGATIVE, NLP_BATCH = 300, 5, 5, 512
NLP_WARMUP, NLP_TIMED = 5, 200
NLP_SG_SENTENCES = 19        # gives >= NLP_WARMUP + NLP_TIMED batches
NLP_PARITY_BATCHES = 50
NLP_PROFILED = (NLP_WARMUP, NLP_WARMUP + 30)   # batches under the profiler
NLP_PARITY_TOL = 1e-5        # max |card - CPU| / max |table|
NLP_CBOW_SENTENCES = 3       # (c): a few batches each
NLP_GLOVE_SENTENCES = 1
NLP_PV_DOCS = 2
NLP_INFER_STEPS = 5
# DeepWalk's paper (Perozzi et al. 2014) on BlogCatalog's node and edge
# counts; one walk a vertex, the fit cut to its first DW_BATCHES batches
DW_NODES, DW_EDGES = 10312, 333983
DW_DIM, DW_WINDOW, DW_WALK, DW_BATCHES = 128, 10, 40, 20
# test_native.py's tolerances
NATIVE_TOL = {"gemm": 1e-4, "transform": 1e-6, "sum": 1e-3, "mean": 1e-4,
              "csv_rtol": 1e-5, "sg_ns": 1e-5}


class _StopFit(Exception):
    """Raised by a step clock to end a fit after a number of batches."""


class _Spy:
    """Stands in for a module-level function: calls it, records host
    entry and exit times, the device time by CUDA events when `cuda`, and
    hands (args, out) to `keep`."""

    def __init__(self, fn, cuda=False, keep=None, sync=False):
        self.fn, self.cuda, self.keep, self.sync = fn, cuda, keep, sync
        self.entries, self.exits, self.events = [], [], []

    def __call__(self, *args):
        self.entries.append(time.perf_counter())
        if self.cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        out = self.fn(*args)
        if self.cuda:
            ev[1].record()
            self.events.append(ev)
        if self.sync:
            torch.cuda.synchronize()
        if self.keep is not None:
            self.keep(args, out)
        self.exits.append(time.perf_counter())
        return out

    def device_ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]

    def host_s(self) -> float:
        return sum(b - a for a, b in zip(self.entries, self.exits))


def _spy(patches, module, name, cls=_Spy, **kw):
    """Puts a `cls` spy in place of `module.name`; `_restore(patches)`
    puts the function back."""
    spy = cls(getattr(module, name), **kw)
    patches.append((module, name, getattr(module, name)))
    setattr(module, name, spy)
    return spy


class _NlpStepClock(_Spy):
    """A spy on one of `embeddings.sequencevectors`' device steps: the
    host seconds since the previous step returned (sampling the batch and
    queueing its copies) are `entries[i] - exits[i - 1]`; also keeps the
    tables it was handed and the rows of each batch; runs the steps
    numbered `profile_window` (lo, hi) under torch.profiler (the card
    idle before and after the window); raises _StopFit after
    `stop_after` steps."""

    def __init__(self, fn, cuda, stop_after=None, profile_window=None):
        super().__init__(fn, cuda=cuda)
        self.stop_after, self.profile_window = stop_after, profile_window
        self.steps, self.rows, self.tables = 0, [], None
        self.prof, self.window_s = None, None

    def _toggle_profiler(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        if self.prof is None:
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.start()
            self._window_t0 = time.perf_counter()
        else:
            self.window_s = time.perf_counter() - self._window_t0
            self.prof.stop()

    def __call__(self, *args):
        if self.profile_window and self.steps in self.profile_window:
            self._toggle_profiler()
        out = super().__call__(*args)
        self.tables = args[:2]
        self.rows.append(int(args[2].shape[0]))
        self.steps += 1
        if self.stop_after is not None and self.steps >= self.stop_after:
            raise _StopFit
        return out


def _restore(monkeypatch_list):
    while monkeypatch_list:
        module, name, fn = monkeypatch_list.pop()
        setattr(module, name, fn)


def _table_rel(card, cpu) -> float:
    card = np.asarray(card, np.float64)
    cpu = np.asarray(cpu, np.float64)
    return float(np.abs(card - cpu).max() / max(np.abs(cpu).max(), 1e-30))


def _tensor_np(t):
    return t.detach().cpu().numpy().copy()


def nlp_native_checks():
    """(a) every native entry point against its numpy twin on seeded
    inputs, with test_native.py's tolerances; returns the rows."""
    import ctypes
    from collections import Counter
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.native import ndarray as nd
    from deeplearning4j_tpu_torch.text.native_tokenizer import (
        NativeCorpusEncoder,
    )
    from deeplearning4j_tpu_torch.text.tokenization import (
        CommonPreprocessor, DefaultTokenizerFactory,
    )
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("the native library did not build: g++ is on "
                             "this machine (nvcc needs it)")
    # `seconds`: g++ (0 when the library was found built); `load_s`: the
    # first use, build included
    build = dict(native.BUILD_INFO, load_s=time.perf_counter() - t0)
    native.reset_calls()
    rs = np.random.RandomState(1818)
    errs = {}
    A = rs.randn(37, 23).astype(np.float32)
    B = rs.randn(23, 41).astype(np.float32)
    for ta in (False, True):
        for tb in (False, True):
            got = nd.HostNDArray(A.T.copy() if ta else A).mmul(
                nd.HostNDArray(B.T.copy() if tb else B), transpose_a=ta,
                transpose_b=tb).numpy()
            errs[f"gemm_{int(ta)}{int(tb)}"] = float(np.abs(got - A @ B).max())
    X = rs.randn(19, 31).astype(np.float32)
    a = nd.HostNDArray(X)
    for name, want in (("tanh", np.tanh(X)),
                       ("sigmoid", 1 / (1 + np.exp(-X))),
                       ("relu", np.maximum(X, 0)), ("exp", np.exp(X)),
                       ("square", X * X)):
        errs[name] = float(np.abs(getattr(a, name)().numpy() - want).max()
                           / max(1.0, np.abs(want).max()))
    errs["sum_axis1"] = float(np.abs(a.sum(axis=1).numpy()
                                     - X.sum(1)).max())
    errs["mean_axis0"] = float(np.abs(a.mean(axis=0).numpy()
                                      - X.mean(0)).max())
    errs["max_axis1"] = float(np.abs(a.max(axis=1).numpy() - X.max(1)).max())
    errs["argmax"] = float((a.argmax(axis=1) != X.argmax(1)).sum())
    img = rs.randn(3, 11, 9).astype(np.float32)
    cols = nd.im2col(img, 3, 3, 2, 2, 1, 1)
    y = rs.randn(*cols.shape).astype(np.float32)
    back = nd.col2im(y, 3, 11, 9, 3, 3, 2, 2, 1, 1)
    lib, native._lib = native._lib, None
    native._build_failed = True
    try:                                    # the numpy twins
        cols_np = nd.im2col(img, 3, 3, 2, 2, 1, 1)
        back_np = nd.col2im(y, 3, 11, 9, 3, 3, 2, 2, 1, 1)
    finally:
        native._lib, native._build_failed = lib, False
    errs["im2col"] = float(np.abs(cols - cols_np).max())
    errs["col2im"] = float(np.abs(back - back_np).max())
    M = rs.randn(200, 6).astype(np.float32)
    with tempfile.NamedTemporaryFile("w", suffix=".csv",
                                     delete=False) as f:
        f.write("\n".join(",".join(f"{v:.6g}" for v in r) for r in M)
                + "\n")
        csv_path = f.name
    from deeplearning4j_tpu_torch.data.records import parse_numeric_csv
    mat = parse_numeric_csv(csv_path)
    with open(csv_path) as f:
        want = np.asarray([[float(v) for v in line.split(",")]
                           for line in f], np.float32)
    import os
    os.unlink(csv_path)
    errs["csv_rel"] = float(np.abs(mat - want).max() / np.abs(want).max())
    docs = ["The QUICK brown fox, jumped over 12 lazy dogs!",
            "Hello... world; (parens) [brackets] 'single'",
            "repeated repeated words words a/b c|d"] * 20
    tf = DefaultTokenizerFactory(CommonPreprocessor())
    counts = Counter(t for d in docs for t in tf.tokenize(d))
    enc = NativeCorpusEncoder()
    if enc.count_or_none(docs) != dict(counts):
        raise AssertionError("native token counts differ from the "
                             "python tokenizer's")
    word2id = {w: i for i, w in enumerate(sorted(counts))}
    ids = enc.encode_or_none(docs, word2id)
    if [list(x) for x in ids] != [[word2id[t] for t in tf.tokenize(d)]
                                  for d in docs]:
        raise AssertionError("native encode differs from the python "
                             "tokenizer's ids")
    g = (rs.randn(5000) * 0.01).astype(np.float32)
    g[rs.choice(5000, 60, replace=False)] *= 100
    idx, vals, res = native.threshold_encode(g, 0.1, 40)
    over = np.flatnonzero(np.abs(g) >= 0.1)
    keep = np.sort(over[np.argsort(-np.abs(g[over]), kind="stable")[:40]])
    if not np.array_equal(idx, keep) or not np.array_equal(vals, g[keep]):
        raise AssertionError("native threshold_encode selects other "
                             "elements than its numpy twin")
    want_res = g.copy()
    want_res[keep] = 0.0
    errs["threshold_encode_residual"] = float(np.abs(res - want_res).max())
    dense = rs.randn(5000).astype(np.float32)
    want_dense = dense.copy()
    np.add.at(want_dense, idx, vals)
    errs["decode_accumulate"] = float(np.abs(
        native.decode_accumulate(dense, idx, vals) - want_dense).max())
    V, D = 30, 16
    syn0 = ((rs.rand(V, D) - 0.5) / D).astype(np.float32)
    syn1 = (rs.rand(V, D) * 0.05).astype(np.float32)
    corpus = rs.randint(0, V, 400).astype(np.int32)
    offsets = np.array([0, 150, 400], np.int64)
    table = rs.randint(0, V, 2000).astype(np.int32)
    s0, s1 = syn0.copy(), syn1.copy()
    loss = native.sg_ns_train(s0, s1, corpus, offsets, 4, 5, table, 0.05,
                              1e-4, 400, seed=7, n_threads=1)
    p0, p1 = syn0.astype(np.float64), syn1.astype(np.float64)
    plain = native.sg_ns_train_plain(p0, p1, corpus, offsets, 4, 5, table,
                                     0.05, 1e-4, 400, seed=7)
    errs["sg_ns_train_rel"] = max(_table_rel(s0, p0), _table_rel(s1, p1),
                                  abs(loss - plain) / abs(plain))
    limits = {"gemm": NATIVE_TOL["gemm"], "tanh": NATIVE_TOL["transform"],
              "sigmoid": NATIVE_TOL["transform"], "relu": 0.0,
              "exp": NATIVE_TOL["transform"],
              "square": NATIVE_TOL["transform"],
              "sum_axis1": NATIVE_TOL["sum"], "mean_axis0": NATIVE_TOL["mean"],
              "max_axis1": 0.0, "argmax": 0.0, "im2col": 0.0, "col2im": 0.0,
              "csv_rel": NATIVE_TOL["csv_rtol"],
              "threshold_encode_residual": 0.0, "decode_accumulate": 1e-7,
              "sg_ns_train_rel": NATIVE_TOL["sg_ns"]}
    for name, err in errs.items():
        limit = limits.get(name, limits.get(name.split("_")[0]))
        if not err <= limit:
            raise AssertionError(f"native {name}: {err} > {limit}")
    calls = dict(native.CALLS)
    for fn in ("gemm_f32", "transform_f32", "reduce_f32", "im2col_f32",
               "col2im_f32", "csv_parse_f32", "dl4j_count_tokens",
               "dl4j_tokenize_encode", "threshold_encode_f32",
               "decode_accumulate_f32", "sg_ns_train"):
        if not calls.get(fn):
            raise AssertionError(f"native {fn} was never called")
    return {"build": build, "max_err": errs, "limits": limits,
            "calls": calls}


def nlp_corpus(rs):
    """A seeded synthetic Zipf(1.0) corpus whose vocabulary at
    min_count=5 has NLP_VOCAB types: type r occurs max(5, C / r) times,
    the tokens shuffled and cut into sentences of NLP_SENTENCE tokens
    (the last one shorter)."""
    ranks = np.arange(1, NLP_VOCAB + 1)
    counts = np.maximum(NLP_MIN_COUNT, np.round(
        NLP_MIN_COUNT * NLP_VOCAB / ranks)).astype(np.int64)
    ids = np.repeat(np.arange(NLP_VOCAB), counts)
    rs.shuffle(ids)
    words = np.asarray([f"w{r}" for r in range(NLP_VOCAB)], dtype=object)
    return [" ".join(words[ids[i:i + NLP_SENTENCE]])
            for i in range(0, len(ids), NLP_SENTENCE)]


def _w2v(**kw):
    from deeplearning4j_tpu_torch.embeddings import Word2Vec
    base = dict(layer_size=NLP_LAYER, window=NLP_WINDOW,
                negative=NLP_NEGATIVE, batch_size=NLP_BATCH,
                min_count=NLP_MIN_COUNT, seed=1818)
    base.update(kw)
    return Word2Vec(**base)


def nlp_word2vec(vocab, sentences):
    """(b) skip-gram / negative sampling at full width: the timed fit on
    the card, then the first NLP_PARITY_BATCHES batches on the card and
    on the CPU."""
    from deeplearning4j_tpu_torch.embeddings import sequencevectors as sv
    patched = []
    src = sentences[:NLP_SG_SENTENCES]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w2v = _w2v()
    w2v.vocab = vocab
    clock = _spy(patched, sv, "_sg_ns_step", cls=_NlpStepClock,
                 cuda=True)
    try:
        t0 = time.perf_counter()
        w2v.fit(src)                          # CUDA: the default device
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        _restore(patched)
    if clock.steps < NLP_WARMUP + NLP_TIMED:
        raise AssertionError(f"{clock.steps} batches < "
                             f"{NLP_WARMUP + NLP_TIMED}")
    lo, hi = NLP_WARMUP, NLP_WARMUP + NLP_TIMED
    wall_s = clock.entries[hi] - clock.entries[lo] if hi < clock.steps \
        else clock.exits[hi - 1] - clock.entries[lo]
    host_ms = [1e3 * (clock.entries[i] - clock.exits[i - 1])
               for i in range(lo, hi)]
    enqueue_ms = [1e3 * (clock.exits[i] - clock.entries[i])
                  for i in range(lo, hi)]
    step_ms = [clock.events[i][0].elapsed_time(clock.events[i][1])
               for i in range(lo, hi)]
    pairs = sum(clock.rows[lo:hi])
    table_bytes = 3 * len(vocab) * NLP_LAYER * 4
    row = {"vocab": len(vocab), "layer_size": NLP_LAYER,
           "batch": NLP_BATCH, "batches": clock.steps,
           "timed_batches": NLP_TIMED, "fit_s": fit_s,
           "ms_per_batch": 1e3 * wall_s / NLP_TIMED,
           "host_sampling_ms_per_batch": statistics.mean(host_ms),
           "host_enqueue_ms_per_batch": statistics.mean(enqueue_ms),
           "step_span_ms": statistics.mean(step_ms),
           "step_span_ms_p50": statistics.median(step_ms),
           "pairs_per_s": pairs / wall_s,
           "table_bytes": table_bytes,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    if not np.all(np.isfinite(w2v.vectors)):
        raise AssertionError("word2vec tables are not finite")
    tables = {}
    for device in ("cuda", "cpu"):
        model = _w2v()
        model.vocab = vocab
        clock = _spy(patched, sv, "_sg_ns_step", cls=_NlpStepClock,
                     cuda=False, stop_after=NLP_PARITY_BATCHES,
                     profile_window=NLP_PROFILED if device == "cuda"
                     else None)
        t0 = time.perf_counter()
        try:
            model.fit(src, device=device)
        except _StopFit:
            pass
        finally:
            _restore(patched)
        row[f"parity_fit_s_{device}"] = time.perf_counter() - t0
        tables[device] = [_tensor_np(t) for t in clock.tables]
        if device == "cuda":
            row.update(_profiled_busy(clock))
    row["parity_batches"] = NLP_PARITY_BATCHES
    row["parity_rel"] = {name: _table_rel(a, b) for name, a, b in zip(
        ("w_in", "w_out"), tables["cuda"], tables["cpu"])}
    row["parity_tol"] = NLP_PARITY_TOL
    if not max(row["parity_rel"].values()) <= NLP_PARITY_TOL:
        raise AssertionError(f"word2vec card vs CPU: {row['parity_rel']}")
    return row


def _profiled_busy(clock):
    """The card's busy time (its kernels and copies, from torch.profiler)
    per batch over the clock's profiled window, and its idle share of the
    window's wall time (the profiler's own cost on the host included)."""
    from torch.autograd import DeviceType
    lo, hi = NLP_PROFILED
    busy_us = sum(e.us for e in profiler_events(clock.prof)
                  if e.device_type == DeviceType.CUDA)
    if not busy_us:
        return {"device_busy_ms_per_batch": "not measured",
                "device_idle_share": "not measured"}
    return {"profiled_batches": [lo, hi],
            "profiled_ms_per_batch": 1e3 * clock.window_s / (hi - lo),
            "device_busy_ms_per_batch": busy_us / 1e3 / (hi - lo),
            "device_idle_share": 1.0 - busy_us / (1e6 * clock.window_s)}


def _card_and_cpu(make, fit, read, steps):
    """Runs `fit(make(), device)` on the card and on the CPU, counting
    the device steps named in `steps`; returns ({name: rel}, counts,
    card seconds)."""
    from deeplearning4j_tpu_torch.embeddings import glove
    from deeplearning4j_tpu_torch.embeddings import sequencevectors as sv
    out, counts, seconds = {}, {}, None
    for device in ("cuda", "cpu"):
        patched = []
        clocks = {s: _spy(patched, glove if s == "_glove_step" else sv, s,
                          cls=_NlpStepClock, cuda=False) for s in steps}
        t0 = time.perf_counter()
        try:
            model = fit(make(), device)
            if device == "cuda":
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            _restore(patched)
        out[device] = read(model)
        counts[device] = {s: c.steps for s, c in clocks.items()}
    if counts["cuda"] != counts["cpu"] or not all(counts["cuda"].values()):
        raise AssertionError(f"device steps: {counts}")
    rel = {k: _table_rel(out["cuda"][k], out["cpu"][k]) for k in out["cpu"]}
    return rel, counts["cuda"], seconds


def nlp_others(vocab, hs_vocab, sentences):
    """(c) CBOW / hierarchical softmax, GloVe, ParagraphVectors' DBOW
    label step and infer_vector at the same width, card against CPU."""
    from deeplearning4j_tpu_torch.embeddings import Glove, ParagraphVectors
    rows = {}

    def cbow():
        m = _w2v(negative=0, use_hierarchic_softmax=True,
                 elements_learning_algorithm="cbow")
        m.vocab = hs_vocab
        return m
    rel, steps, s = _card_and_cpu(
        cbow, lambda m, d: m.fit(sentences[:NLP_CBOW_SENTENCES], device=d),
        lambda m: {"w_in": m.vectors, "syn1": m.syn1}, ("_cbow_hs_step",))
    rows["cbow_hs"] = {"rel": rel, "steps": steps, "card_s": s,
                       "max_code_length": hs_vocab.max_code_length()}

    def glove():
        m = Glove(layer_size=NLP_LAYER, window=NLP_WINDOW, epochs=1,
                  batch_size=NLP_BATCH, min_count=NLP_MIN_COUNT, seed=1818)
        m.vocab = vocab
        return m
    rel, steps, s = _card_and_cpu(
        glove, lambda m, d: m.fit(sentences[:NLP_GLOVE_SENTENCES], device=d),
        lambda m: {"w_plus_wc": m.vectors, "loss": np.float64(m.last_loss)},
        ("_glove_step",))
    rows["glove"] = {"rel": rel, "steps": steps, "card_s": s}

    docs = [(f"doc_{i}", sentences[i]) for i in range(NLP_PV_DOCS)]
    infer_text = sentences[NLP_PV_DOCS][:2000]

    def pv():
        m = ParagraphVectors(layer_size=NLP_LAYER, window=NLP_WINDOW,
                             negative=NLP_NEGATIVE, batch_size=NLP_BATCH,
                             min_count=NLP_MIN_COUNT, seed=1818)
        m.vocab = vocab
        return m

    def pv_read(m):
        return {"w_in": m.vectors, "labels": m.label_vectors,
                "infer": m.infer_vector(infer_text, steps=NLP_INFER_STEPS)}
    rel, steps, s = _card_and_cpu(pv, lambda m, d: m.fit(docs, device=d),
                                  pv_read, ("_sg_ns_step",))
    rows["paragraph_vectors"] = {"rel": rel, "steps": steps, "card_s": s,
                                 "infer_steps": NLP_INFER_STEPS}
    for name, r in rows.items():
        if not max(r["rel"].values()) <= NLP_PARITY_TOL:
            raise AssertionError(f"{name} card vs CPU: {r['rel']}")
    return rows


def nlp_deepwalk():
    """(d) DeepWalk at its paper's width on a seeded random graph of
    BlogCatalog's node and edge counts, through `fit_graph`: one walk from
    every vertex, the vocabulary and tables over all of them, the fit
    stopped after DW_BATCHES batches; card against CPU."""
    from deeplearning4j_tpu_torch.embeddings import sequencevectors as sv
    from deeplearning4j_tpu_torch.graph import DeepWalk, Graph
    rs = np.random.RandomState(2014)
    a = rs.randint(0, DW_NODES, 2 * DW_EDGES)
    b = rs.randint(0, DW_NODES, 2 * DW_EDGES)
    keep = a != b
    edges = list(zip(a[keep][:DW_EDGES].tolist(), b[keep][:DW_EDGES].tolist()))
    t0 = time.perf_counter()
    graph = Graph.from_edges(edges, n_vertices=DW_NODES)
    graph_s = time.perf_counter() - t0
    tables, row = {}, {}
    for device in ("cuda", "cpu"):
        patched = []
        clock = _spy(patched, sv, "_sg_ns_step", cls=_NlpStepClock,
                     cuda=False, stop_after=DW_BATCHES)
        model = DeepWalk(layer_size=DW_DIM, window=DW_WINDOW,
                         walk_length=DW_WALK, walks_per_vertex=1,
                         batch_size=NLP_BATCH, seed=2014)
        t0 = time.perf_counter()
        try:
            model.fit_graph(graph, device=device)
        except _StopFit:
            pass
        finally:
            _restore(patched)
        if device == "cuda":
            torch.cuda.synchronize()
            row = {"fit_s": time.perf_counter() - t0,
                   "walks_and_vocab_s": clock.entries[0] - t0,
                   "vocab": len(model.vocab)}
        tables[device] = [_tensor_np(t) for t in clock.tables]
        if clock.steps != DW_BATCHES:
            raise AssertionError(f"deepwalk on {device}: {clock.steps} "
                                 f"batches != {DW_BATCHES}")
    shapes = [t.shape for t in tables["cuda"]]
    if row["vocab"] != DW_NODES or shapes != [(DW_NODES, DW_DIM)] * 2:
        raise AssertionError(f"deepwalk vocabulary {row['vocab']}, "
                             f"tables {shapes}")
    rel = {name: _table_rel(x, y) for name, x, y in zip(
        ("w_in", "w_out"), tables["cuda"], tables["cpu"])}
    if not max(rel.values()) <= NLP_PARITY_TOL:
        raise AssertionError(f"deepwalk card vs CPU: {rel}")
    return {"nodes": DW_NODES, "edges": graph.num_edges(), "dim": DW_DIM,
            "window": DW_WINDOW, "walk_length": DW_WALK,
            "walks": DW_NODES, "batches": DW_BATCHES,
            "graph_s": graph_s, **row, "rel": rel}


def nlp(fa, gpu):
    """Phase 18: the native host library, then the embedding trainers at
    full width on the card, each against the CPU."""
    from deeplearning4j_tpu_torch import native
    t_phase = time.perf_counter()
    row = {"phase": "nlp", "gpu": gpu}
    row["native"] = nlp_native_checks()
    emit({"phase": "nlp_native", "gpu": gpu, **row["native"]})
    t0 = time.perf_counter()
    sentences = nlp_corpus(np.random.RandomState(1818))
    corpus_s = time.perf_counter() - t0
    for k in fa.KERNEL_LAUNCHES:
        fa.KERNEL_LAUNCHES[k] = 0
    native.reset_calls()
    t0 = time.perf_counter()
    w2v = _w2v()
    w2v.build_vocab(sentences)               # the native counting pass
    vocab_s = time.perf_counter() - t0
    calls = dict(native.CALLS)
    if len(w2v.vocab) != NLP_VOCAB or not calls.get("dl4j_count_tokens"):
        raise AssertionError(f"vocabulary {len(w2v.vocab)} types, native "
                             f"calls {calls}")
    row["corpus"] = {"tokens": len(sentences) * NLP_SENTENCE,
                     "sentences": len(sentences), "vocab": len(w2v.vocab),
                     "build_s": corpus_s, "vocab_s": vocab_s,
                     "native_calls": calls}
    t0 = time.perf_counter()
    row["word2vec_sg_ns"] = nlp_word2vec(w2v.vocab, sentences)
    row["word2vec_s"] = time.perf_counter() - t0
    emit({"phase": "nlp_word2vec", "gpu": gpu, **row["word2vec_sg_ns"]})
    t0 = time.perf_counter()
    hs_vocab = copy_vocab(w2v.vocab).build_huffman()
    row["huffman_s"] = time.perf_counter() - t0
    row["others"] = nlp_others(w2v.vocab, hs_vocab, sentences)
    row["others_s"] = time.perf_counter() - t0 - row["huffman_s"]
    t0 = time.perf_counter()
    row["deepwalk"] = nlp_deepwalk()
    row["deepwalk_s"] = time.perf_counter() - t0
    row["flash_launches"] = dict(fa.KERNEL_LAUNCHES)
    if any(row["flash_launches"].values()):
        raise AssertionError(f"the nlp path launched flash kernels: "
                             f"{row['flash_launches']}")
    row["seconds"] = time.perf_counter() - t_phase
    row["budget_s"] = NLP_BUDGET_S
    emit({k: v for k, v in row.items() if k not in ("native",
                                                     "word2vec_sg_ns")})
    if row["seconds"] > NLP_BUDGET_S:
        raise AssertionError(f"phase 18 took {row['seconds']:.1f} s "
                             f"> {NLP_BUDGET_S}")
    return row


def copy_vocab(vocab):
    """A copy of a built VocabCache (Huffman codes go on the copy)."""
    from deeplearning4j_tpu_torch.embeddings.vocab import VocabCache
    out = VocabCache()
    for w in vocab.vocab_words():
        out.add_token(w.word, w.count)
    return out.build(1)


# ------------------------------------------------------------------ phase 19
INTEROP_BUDGET_S = 60.0
VGG_HW, VGG_CLASSES, VGG_FC = 224, 1000, 4096     # the zoo's VGG16
VGG_FIT_BATCH = 16           # (a): 2 steps, written, restored, 2 more
VGG_PREDICT_BATCH = 2
VGG_CPU_REL = 1e-4           # (a): the CPU restore's predict
KERAS_REL = 1e-5             # (b): against (a)'s predict
EST_HIDDEN = (512, 256)      # (c)
EST_EPOCHS, EST_BATCH, EST_TOL = 2, 32, 1e-5
UI_STEPS, UI_BATCH = 4, 4    # (d)
UI_NORM_REL = 1e-6
UI_BINS = 20


def plain_summarize(arrays, n_bins=UI_BINS):
    """The reference's StatsListener summary (its `_summarize`, histograms
    on), in float64 numpy on the host: the plain version (d) holds the
    port's on-device summaries against."""
    summary = {}
    for path, a in arrays.items():
        a = np.asarray(a).astype("float64", copy=False).ravel()
        finite = a[np.isfinite(a)]
        entry = {"norm": float(np.linalg.norm(finite)),
                 "mean_mag": float(np.abs(finite).mean()) if finite.size
                 else 0.0,
                 "n_non_finite": int(a.size - finite.size)}
        if finite.size:
            lo, hi = float(finite.min()), float(finite.max())
            if lo == hi:
                hi = lo + 1e-12
            counts, _ = np.histogram(finite, bins=n_bins, range=(lo, hi))
        else:
            lo, hi, counts = 0.0, 0.0, np.zeros(n_bins, dtype=int)
        entry["hist"] = counts.tolist()
        entry["lo"], entry["hi"] = lo, hi
        summary[path] = entry
    return summary


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def vgg16_keras_config():
    """VGG16's Keras Sequential config (keras.applications' layer names),
    written by hand."""
    layers = [{"class_name": "InputLayer", "config": {
        "name": "input_1", "batch_shape": [None, VGG_HW, VGG_HW, 3]}}]
    for block, (n_convs, filters) in enumerate(
            [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)], 1):
        for i in range(1, n_convs + 1):
            layers.append({"class_name": "Conv2D", "config": {
                "name": f"block{block}_conv{i}", "filters": filters,
                "kernel_size": [3, 3], "strides": [1, 1],
                "padding": "same", "activation": "relu",
                "use_bias": True}})
        layers.append({"class_name": "MaxPooling2D", "config": {
            "name": f"block{block}_pool", "pool_size": [2, 2],
            "strides": [2, 2], "padding": "valid"}})
    layers.append({"class_name": "Flatten", "config": {"name": "flatten"}})
    for name, units, act in (("fc1", VGG_FC, "relu"),
                             ("fc2", VGG_FC, "relu"),
                             ("predictions", VGG_CLASSES, "softmax")):
        layers.append({"class_name": "Dense", "config": {
            "name": name, "units": units, "activation": act,
            "use_bias": True}})
    return {"class_name": "Sequential",
            "config": {"name": "vgg16", "layers": layers}}


def write_keras_h5(path, config, named_weights):
    """A Keras 2 HDF5 archive: `model_config`, and under `model_weights`
    one group a layer with its `weight_names` and datasets."""
    import h5py
    with h5py.File(path, "w") as f:
        f.attrs["model_config"] = json.dumps(config)
        root = f.create_group("model_weights")
        for layer, weights in named_weights:
            g = root.create_group(layer)
            names = [f"{layer}/{w}:0" for w, _ in weights]
            g.attrs["weight_names"] = [n.encode() for n in names]
            sub = g.create_group(layer)
            for (w, arr), _ in zip(weights, names):
                sub.create_dataset(f"{w}:0", data=arr)


def interop_dl4j(tmp):
    """(a) VGG16 through the DL4J zip: written and restored on the card,
    bitwise, its training carried on bitwise; restored on the CPU."""
    import os
    from deeplearning4j_tpu_torch.modelimport import (
        restore_multilayer_network, save_dl4j_model,
    )
    from deeplearning4j_tpu_torch.models.zoo import VGG16
    from deeplearning4j_tpu_torch.nn.conf.base import InputType
    in_type = InputType.convolutional(VGG_HW, VGG_HW, 3)
    rs = np.random.RandomState(1919)
    batches = [(rs.rand(VGG_FIT_BATCH, VGG_HW, VGG_HW, 3).astype(np.float32),
                np.eye(VGG_CLASSES, dtype=np.float32)[
                    rs.randint(0, VGG_CLASSES, VGG_FIT_BATCH)])
               for _ in range(4)]
    x = batches[3][0][:VGG_PREDICT_BATCH]
    row = {}
    src = VGG16(num_classes=VGG_CLASSES,
                input_shape=(VGG_HW, VGG_HW, 3)).init()
    row["parameters"] = src.num_params()
    t0 = time.perf_counter()
    for xb, yb in batches[:2]:
        src.fit((xb, yb), batch_size=VGG_FIT_BATCH)
    torch.cuda.synchronize()
    row["fit_2_steps_s"] = time.perf_counter() - t0
    path = os.path.join(tmp, "vgg16_dl4j.zip")
    t0 = time.perf_counter()
    save_dl4j_model(src, path)
    row["write_s"] = time.perf_counter() - t0
    row["zip_bytes"] = os.path.getsize(path)
    t0 = time.perf_counter()
    net = restore_multilayer_network(path, input_type=in_type)
    torch.cuda.synchronize()
    row["read_s"] = time.perf_counter() - t0
    row["params_bitwise"] = _bitwise(net.params, src.params)
    y0 = src.output(x)
    row["predict_bitwise"] = bool(torch.equal(net.output(x), y0))
    saved = {k: {n: t.detach().cpu().clone() for n, t in v.items()}
             for k, v in src.params.items() if v}
    # the DL4J zip carries no counters: the restored network continues
    # the source's epoch (its dropout generator is seeded by the epoch)
    net.epoch_count, net.iteration_count = src.epoch_count, \
        src.iteration_count
    for xb, yb in batches[2:]:
        src.fit((xb, yb), batch_size=VGG_FIT_BATCH)
        net.fit((xb, yb), batch_size=VGG_FIT_BATCH)
    row["next_2_steps_bitwise"] = _bitwise(net.params, src.params)
    del src, net
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu = restore_multilayer_network(path, load_updater=False,
                                     input_type=in_type, device="cpu")
    row["cpu_read_s"] = time.perf_counter() - t0
    row["cpu_predict_rel"] = _rel(cpu.output(x).numpy(), y0.cpu().numpy())
    del cpu
    if not (row["params_bitwise"] and row["predict_bitwise"]
            and row["next_2_steps_bitwise"]):
        raise AssertionError(f"phase 19 (a): the DL4J round trip is not "
                             f"bitwise: {row}")
    if not row["cpu_predict_rel"] <= VGG_CPU_REL:
        raise AssertionError(f"phase 19 (a): the CPU restore predicts "
                             f"{row['cpu_predict_rel']:.3g} off")
    return row, saved, x, y0


def interop_keras(tmp, saved, x, y0):
    """(b) VGG16 from its Keras config, given (a)'s weights in order; the
    .h5 through the registry when h5py is on the machine."""
    import os
    from deeplearning4j_tpu_torch.modelimport import KerasModelImport
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
    from deeplearning4j_tpu_torch.serving.registry import (
        ModelLoadError, load_servable,
    )
    cfg = vgg16_keras_config()
    cfg_path = os.path.join(tmp, "vgg16_keras.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    row = {}
    t0 = time.perf_counter()
    knet = KerasModelImport.import_keras_model_configuration(cfg_path)
    knet.init()
    row["import_s"] = time.perf_counter() - t0
    src_keys = [k for k in sorted(saved, key=int)]
    k_keys = [str(i) for i, _ in enumerate(knet.layers)
              if knet.params[str(i)]]
    if len(src_keys) != 16 or len(k_keys) != 16:
        raise AssertionError(f"phase 19 (b): {len(k_keys)} weighted Keras "
                             f"layers against {len(src_keys)}")
    with torch.no_grad():
        for ks, kk in zip(src_keys, k_keys):
            for name, t in knet.params[kk].items():
                t.copy_(saved[ks][name])
    yk = knet.output(x)
    row["predict_rel"] = _rel(yk.cpu().numpy(), y0.cpu().numpy())
    if not row["predict_rel"] <= KERAS_REL:
        raise AssertionError(f"phase 19 (b): the Keras VGG16 predicts "
                             f"{row['predict_rel']:.3g} off")
    del knet
    h5_path = os.path.join(tmp, "vgg16.h5")
    try:
        import h5py  # noqa: F401
        row["h5py"] = True
    except ImportError:
        row["h5py"] = False
    if row["h5py"]:
        names = [c["config"]["name"] for c in cfg["config"]["layers"]
                 if c["class_name"] in ("Conv2D", "Dense")]
        t0 = time.perf_counter()
        write_keras_h5(h5_path, cfg, [
            (name, [("kernel", saved[k]["W"].numpy()),
                    ("bias", saved[k]["b"].numpy())])
            for name, k in zip(names, src_keys)])
        row["h5_write_s"] = time.perf_counter() - t0
        row["h5_bytes"] = os.path.getsize(h5_path)
        registry = ModelRegistry()
        t0 = time.perf_counter()
        registry.deploy("vgg16", h5_path, buckets=(VGG_PREDICT_BATCH,))
        row["deploy_s"] = time.perf_counter() - t0
        server = ModelServer(registry, port=0)
        try:
            status, y, ms = post_npy(
                f"{server.url}/v1/models/vgg16/predict", x)
        finally:
            server.drain(timeout=30)
            registry.shutdown()
        row["http_status"], row["http_ms"] = status, ms
        row["http_predict_rel"] = _rel(y, y0.cpu().numpy())
        if status != 200 or not row["http_predict_rel"] <= KERAS_REL:
            raise AssertionError(f"phase 19 (b): the served .h5 answered "
                                 f"{status}, {row['http_predict_rel']}")
    else:
        with open(h5_path, "wb") as f:
            f.write(b"\x89HDF\r\n\x1a\n")
        try:
            load_servable(h5_path)
        except ModelLoadError as e:
            row["h5_refusal"] = str(e)
        if "h5py" not in row.get("h5_refusal", ""):
            raise AssertionError("phase 19 (b): without h5py an .h5 source "
                                 "must raise ModelLoadError naming h5py")
    torch.cuda.empty_cache()
    return row


def interop_estimators():
    """(c) DL4JClassifier on the seeded synthetic MNIST, on the card."""
    import pickle
    from deeplearning4j_tpu_torch.data.fetchers import MnistDataSetIterator
    from deeplearning4j_tpu_torch.ml import DL4JClassifier
    from deeplearning4j_tpu_torch.util.serialization import (
        load_model, save_model,
    )
    ds = next(iter(MnistDataSetIterator(batch_size=2048, synthetic=True,
                                        flatten=True)))
    X, y = np.asarray(ds.features), np.asarray(ds.labels).argmax(1)
    row = {"examples": int(len(X)), "features": int(X.shape[1])}
    t0 = time.perf_counter()
    clf = DL4JClassifier(hidden=EST_HIDDEN, epochs=EST_EPOCHS,
                         batch_size=EST_BATCH).fit(X, y)
    row["fit_s"] = time.perf_counter() - t0
    row["device"] = str(clf.network_.device)
    proba = clf.predict_proba(X)
    buf = io.BytesIO()
    save_model(clf.network_, buf)
    buf.seek(0)
    cpu = load_model(buf, device="cpu")
    row["cpu_max_abs"] = float(np.abs(
        cpu.output(X).numpy() - proba).max())
    row["accuracy"] = float((clf.predict(X) == y).mean())
    back = pickle.loads(pickle.dumps(clf))
    row["pickle_bitwise"] = _bitwise(back.network_.params,
                                           clf.network_.params) \
        and bool(np.array_equal(back.predict_proba(X), proba))
    if row["device"] != "cuda" or not row["cpu_max_abs"] <= EST_TOL \
            or not row["pickle_bitwise"]:
        raise AssertionError(f"phase 19 (c): {row}")
    return row


def _ui_watch(times, pages, last):
    """Wraps for (d): the dashboard's server (its URL), the listener's
    time a capture (on_gradients + iteration_done), the step's time, the
    pages fetched while the run is live (at the third record), and into
    `last` the last capture step's parameters and optimizer state before
    it, its gradients, its updates and its updater."""
    import urllib.request
    from deeplearning4j_tpu_torch.nn import multilayer
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.ui import server as ui_server
    from deeplearning4j_tpu_torch.ui import stats
    saved = [(ui_server.UIServer, "__init__"),
             (stats.StatsListener, "on_gradients"),
             (stats.StatsListener, "iteration_done"),
             (multilayer.TrainableNet, "_capturing")]
    orig = {key: getattr(*key) for key in saved}
    servers = []

    def init(self, *a, **kw):
        orig[saved[0]](self, *a, **kw)
        servers.append(self)

    def timed(key, bucket):
        def run(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[key](self, *a, **kw)
            torch.cuda.synchronize()
            times[bucket].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    def done(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orig[saved[2]](self, *a, **kw)
        times["iteration_done_ms"].append((time.perf_counter() - t0) * 1e3)
        if len(times["iteration_done_ms"]) == 3 and servers:
            url = servers[-1].url
            for name, path in (("overview", "train"),
                               ("system", "train/system")):
                with urllib.request.urlopen(url + path, timeout=30) as r:
                    pages[name] = (r.status, len(r.read()))
            with urllib.request.urlopen(url + "train/sessions",
                                        timeout=30) as r:
                sid = json.loads(r.read())["sessions"][0]
            with urllib.request.urlopen(
                    f"{url}train/data?sid={sid}&after=0", timeout=60) as r:
                pages["model_json"] = json.loads(r.read())
    step = timed(saved[3], "step_ms")

    def capturing(self, fn):
        # the state before the step, copied outside the step's time
        before = {"params": upd.tree_map(torch.clone, self.params),
                  "opt": upd.tree_map(torch.clone, self.opt_state)}
        out, grads, updates = step(self, fn)
        last.update(before, grads=grads, updates=updates, tx=self._tx)
        return out, grads, updates
    ui_server.UIServer.__init__ = init
    stats.StatsListener.on_gradients = timed(saved[1], "on_gradients_ms")
    stats.StatsListener.iteration_done = done
    multilayer.TrainableNet._capturing = capturing

    def restore():
        for key, fn in orig.items():
            setattr(key[0], key[1], fn)
    return restore


def interop_ui(fa, tmp):
    """(d) The train CLI with --ui-port 0 on the full-width LM: (the row,
    every record the listener stored)."""
    import contextlib
    import os
    import zipfile as zf_mod
    from deeplearning4j_tpu_torch.models.zoo import model_by_name
    from deeplearning4j_tpu_torch.serving.registry import parse_zoo_source
    from deeplearning4j_tpu_torch.train import cli as train_cli
    from deeplearning4j_tpu_torch.ui import storage as ui_storage
    from deeplearning4j_tpu_torch.util.serialization import save_model
    name, kw = parse_zoo_source(LM_SOURCE[len("zoo:"):])
    lm_zip, out_zip = os.path.join(tmp, "lm.zip"), os.path.join(tmp, "o.zip")
    tokens = os.path.join(tmp, "tokens.npz")
    save_model(model_by_name(name, **kw).init(), lm_zip, compression=STORED)
    rs = np.random.RandomState(1919)
    n = UI_STEPS * UI_BATCH
    seq = (rs.randint(0, VOCAB, (n, 1)) + rs.randint(1, 8, (n, 1))
           * np.arange(SEQ + 1)) % VOCAB
    labels = np.zeros((n, SEQ, VOCAB), np.uint8)
    np.put_along_axis(labels, seq[:, 1:, None], 1, axis=-1)
    np.savez(tokens, features=seq[:, :SEQ, None].astype("float32"),
             labels=labels)
    times = {"on_gradients_ms": [], "iteration_done_ms": [], "step_ms": []}
    pages, records, last_step = {}, [], {}
    restore = _ui_watch(times, pages, last_step)
    put = ui_storage.InMemoryStatsStorage.put_update

    def keep(self, rec):
        records.append(rec.data)
        return put(self, rec)
    ui_storage.InMemoryStatsStorage.put_update = keep
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    stdout, stderr = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(stdout), \
                contextlib.redirect_stderr(stderr):
            code = train_cli.main([
                "--model", lm_zip, "--output", out_zip, "--dataset", tokens,
                "--mode", "single", "--batch-size", str(UI_BATCH),
                "--score-every", "1", "--ui-port", "0"])
    finally:
        restore()
        ui_storage.InMemoryStatsStorage.put_update = put
    row = {"cli_s": time.perf_counter() - t0, "exit": code,
           "flash_launches": dict(fa.KERNEL_LAUNCHES)}
    dash = [ln for ln in stderr.getvalue().splitlines()
            if ln.startswith("dashboard: ")]
    row["dashboard"] = dash[0].split(" ", 1)[1] if dash else None
    live = pages.pop("model_json", None)
    row["pages"] = pages
    if code != 0 or row["dashboard"] is None or live is None \
            or pages.get("overview", (0,))[0] != 200 \
            or pages.get("system", (0,))[0] != 200:
        raise AssertionError(f"phase 19 (d): the dashboard run: {row}")
    row["records_seen_live"] = len(live["updates"])
    row["records"] = len(records)
    with zf_mod.ZipFile(out_zip) as zf:
        with np.load(io.BytesIO(zf.read("coefficients.npz"))) as npz:
            final = {k: npz[k] for k in npz.files}
    want = plain_summarize(final)
    bad = [(i, g) for i, r in enumerate(records)
           for g in ("params", "gradients", "updates")
           if set(r.get(g, {})) != set(want)]
    row["leaves"] = len(want)
    row["step_ms"] = times["step_ms"]
    row["on_gradients_ms"] = times["on_gradients_ms"]
    row["iteration_done_ms"] = times["iteration_done_ms"]
    row["capture_ms"] = [a + b for a, b in zip(times["on_gradients_ms"],
                                               times["iteration_done_ms"])]
    if row["records"] != UI_STEPS or row["records_seen_live"] < 2 or bad:
        raise AssertionError(f"phase 19 (d): records {row['records']}, "
                             f"live {row['records_seen_live']}, missing "
                             f"leaves {bad}")
    last = records[-1]["params"]
    hist_bad = [k for k in want if last[k]["hist"] != want[k]["hist"]]
    worst = max(abs(last[k][f] - want[k][f]) / max(abs(want[k][f]), 1e-300)
                for k in want for f in ("norm", "mean_mag"))
    row["last_params_hist_equal"] = not hist_bad
    row["last_params_worst_rel"] = worst
    if hist_bad or not worst <= UI_NORM_REL:
        raise AssertionError(f"phase 19 (d): the last record's params "
                             f"differ from the plain summary: {hist_bad[:5]}"
                             f", worst {worst:.3g}")
    row.update(ui_last_step(last_step, final, records[-1]))
    return row


def ui_last_step(last, final, record):
    """(d): the last record's gradients and updates are the last step's.
    The updater on the step's gradients, from the optimizer state before
    it, gives its updates bitwise; those added to the parameters before it
    give the output zip's bitwise; and the record's gradients and updates
    summaries equal the plain summary of those tensors (counts exactly,
    norms and mean magnitudes within UI_NORM_REL)."""
    from deeplearning4j_tpu_torch.nn import updaters as upd
    from deeplearning4j_tpu_torch.ui.stats import _leaf_paths

    def host(tree):
        return {k: v.cpu().numpy() for k, v in _leaf_paths(tree).items()}
    with torch.no_grad():
        again, _ = last["tx"].update(last["grads"], last["opt"],
                                     last["params"])
        applied = upd.tree_map(lambda p, u: p + u.to(p.dtype),
                               last["params"], last["updates"])
    updates, again, applied = (host(last["updates"]), host(again),
                               host(applied))
    row = {"last_updates_bitwise_updater": all(
               np.array_equal(updates[k], again[k]) for k in updates),
           "last_applied_bitwise_output": set(applied) == set(final)
           and all(np.array_equal(applied[k], final[k]) for k in final)}
    worst, hist_bad = 0.0, []
    for group, tensors in (("gradients", host(last["grads"])),
                           ("updates", updates)):
        want, got = plain_summarize(tensors), record[group]
        hist_bad += [(group, k) for k in want
                     if got[k]["hist"] != want[k]["hist"]]
        worst = max([worst] + [
            abs(got[k][f] - want[k][f]) / max(abs(want[k][f]), 1e-300)
            for k in want for f in ("norm", "mean_mag")])
    row["last_grads_updates_hist_equal"] = not hist_bad
    row["last_grads_updates_worst_rel"] = worst
    if not (row["last_updates_bitwise_updater"]
            and row["last_applied_bitwise_output"]) or hist_bad \
            or not worst <= UI_NORM_REL:
        raise AssertionError(f"phase 19 (d): the last record's gradients "
                             f"and updates are not the last step's: {row}, "
                             f"{hist_bad[:5]}")
    return row


def interop(fa, gpu):
    """Phase 19: model import, estimators and the dashboard at full
    width."""
    import tempfile
    t_phase = time.perf_counter()
    row = {"phase": "interop", "gpu": gpu}
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            row["dl4j"], saved, x, y0 = interop_dl4j(tmp)
            row["dl4j"]["seconds"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            row["keras"] = interop_keras(tmp, saved, x, y0)
            row["keras"]["seconds"] = time.perf_counter() - t0
        del saved
        t0 = time.perf_counter()
        row["estimators"] = interop_estimators()
        row["estimators"]["seconds"] = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = deterministic
    row["interop_flash_launches"] = dict(fa.KERNEL_LAUNCHES)
    if any(row["interop_flash_launches"].values()):
        raise AssertionError(f"phase 19 (a)-(c) launched flash kernels: "
                             f"{row['interop_flash_launches']}")
    emit({"phase": "interop_abc", "gpu": gpu, "h5py": row["keras"]["h5py"],
          **{k: row[k] for k in ("dl4j", "keras", "estimators")}})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        row["ui"] = interop_ui(fa, tmp)
        row["ui"]["seconds"] = time.perf_counter() - t0
    row["flash_launches"] = row["ui"]["flash_launches"]
    expect = N_LAYERS * UI_STEPS
    if any(row["flash_launches"][k] != expect for k in KERNELS):
        raise AssertionError(f"phase 19 (d): flash launches "
                             f"{row['flash_launches']}, expected {expect} "
                             "of each")
    row["h5py"] = row["keras"]["h5py"]
    row["seconds"] = time.perf_counter() - t_phase
    row["budget_s"] = INTEROP_BUDGET_S
    emit({k: v for k, v in row.items()
          if k not in ("dl4j", "keras", "estimators")})
    if row["seconds"] > INTEROP_BUDGET_S:
        raise AssertionError(f"phase 19 took {row['seconds']:.1f} s "
                             f"> {INTEROP_BUDGET_S}")
    return row


# ------------------------------------------------------------------ phase 20
APPS_BUDGET_S = 75.0
APPS_POINTS = 70000          # MNIST's train plus test images, 784 features
APPS_SEED = 123              # the fetchers' synthetic MNIST seed
APPS_K = 10
APPS_LLOYD = 10              # (a): Lloyd iterations (the default 100, cut)
APPS_TILE = 1024
APPS_PERPLEXITY = 30.0       # k = 90 neighbours
APPS_EXACT_ITERS = 25        # (b): of the default 500, cut (50 to PR 21)
APPS_BH_ITERS = 10           # (c): host Barnes-Hut iterations (20 to PR 21)
APPS_SMALL = 10000           # (c)'s second timing and (d)'s exact Tsne
APPS_PCA_INIT = False        # (b), (c): the seeded Gaussian start; the PCA
                             # start's numpy SVD of 70,000 x 784 took
                             # 6.7-7.0 s a fit on the H100 machine's host
                             # CPU, and (d) drives it
APPS_SAMPLED_ROWS = 1024     # (b): repulsion rows held on the CPU
APPS_TOL = 1e-5
APPS_MEMORY_SHARE = 0.10     # (b): of one N x N f32 matrix
APPS_BH_Z_REL = 0.02         # (c): the bound of test_bhtsne.py:126
APPS_PURITY = 0.95           # (d): the bound of test_bhtsne.py:87
APPS_P_ROWS = 256            # (d): conditional P rows held against the CPU
NN_ROWS, NN_DIM, NN_K = 71290, 300, 10    # (e): phase 18's vocabulary size
NN_NEW, NN_INDEXED = 3, 2   # (e): queries, each ~0.3 s in 300 dimensions
                             # (5 and 3 to PR 21)
NN_INSERTS, NN_AFTER = 256, 1
LSH_BITS, LSH_TABLES = 16, 4
KD_QUERIES = 200
RP_DIM, RP_PAIRS = 64, 1000


def _timed_method(obj, name):
    """Wraps a bound method of `obj`; returns the list its seconds go to."""
    fn, took = getattr(obj, name), []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        took.append(time.perf_counter() - t0)
        return out
    setattr(obj, name, timed)
    return took


def _mean(xs):
    return float(statistics.fmean(xs)) if xs else None


def apps_data():
    from deeplearning4j_tpu_torch.data.fetchers import _synthetic_images
    X, Y = _synthetic_images(APPS_POINTS, 28, 28, 1, 10, APPS_SEED)
    return np.ascontiguousarray(X.reshape(APPS_POINTS, -1)), Y.argmax(1)


def _rounding_tie(x, a, b) -> bool:
    """Whether the f64 gap between |x - a|^2 and |x - b|^2 lies within the
    rounding scale of the f32 expansion |x|^2 - 2 x.c + |c|^2 over D
    terms, 2^-24 sqrt(D) (2|x|^2 + |a|^2 + |b|^2): two BLASes summing in
    other orders may then order the pair either way."""
    x, a, b = (np.asarray(v, np.float64) for v in (x, a, b))
    gap = abs(((x - a) ** 2).sum() - ((x - b) ** 2).sum())
    scale = 2.0 ** -24 * math.sqrt(len(x)) * (2 * (x @ x) + a @ a + b @ b)
    return bool(gap <= scale)


def _tie_rows(X, centers, rows):
    """Of `rows`, the two nearest centers (f64 distances on the host), and
    whether they tie: within APPS_TOL relative (`rel_tie`) and within the
    f32 expansion's rounding scale (`tie`)."""
    out = []
    for r in rows:
        d = np.linalg.norm(X[r].astype(np.float64)
                           - centers.astype(np.float64), axis=1)
        a, b = np.argsort(d)[:2]
        out.append({"row": int(r), "d0": float(d[a]), "d1": float(d[b]),
                    "rel_tie": bool(d[b] - d[a] <= APPS_TOL * d[b]),
                    "tie": _rounding_tie(X[r], centers[a], centers[b])})
    return out


def apps_kmeans(X):
    """(a): 10 Lloyd iterations of k = 10 on the card and on the CPU.
    Each of the card's assignments is held against the CPU's on the same
    centers (a differing row must be a tie); the two fits' centers are
    bitwise when no tie flipped on the way."""
    from deeplearning4j_tpu_torch.clustering import KMeansClustering, kmeans
    kept = {"cuda": [], "cpu": []}

    def keep(args, out):
        kept["cuda" if spy.cuda else "cpu"].append(
            (args[1].cpu().numpy(), out[0].cpu().numpy()))
    patches = []
    card = KMeansClustering(k=APPS_K, max_iterations=APPS_LLOYD, seed=0)
    cpu = KMeansClustering(k=APPS_K, max_iterations=APPS_LLOYD, seed=0,
                           device="cpu")
    seed_s = _timed_method(card, "_init_centers")
    spy = _spy(patches, kmeans, "_assign", cuda=True, keep=keep)
    try:
        t0 = time.perf_counter()
        card.fit(X)
        t_end = time.perf_counter()
        assign_ms = spy.device_ms()
        spy.cuda = False
        t1 = time.perf_counter()
        cpu.fit(X)
        cpu_s = time.perf_counter() - t1
    finally:
        _restore(patches)
    n_card = len(kept["cuda"])
    updates_ms = [(spy.entries[i + 1] - spy.exits[i]) * 1e3
                  for i in range(n_card - 1)] + [(t_end - spy.exits[n_card - 1])
                                                 * 1e3]
    t_check = time.perf_counter()
    Xc = torch.as_tensor(X)
    flips = []
    for i, (centers, idx) in enumerate(kept["cuda"]):
        mine = kmeans._assign(Xc, torch.as_tensor(centers))[0].numpy()
        rows = np.flatnonzero(mine != idx)
        flips += [dict(r, iteration=i) for r in _tie_rows(X, centers, rows)]
    same = n_card == len(kept["cpu"]) and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        for a, b in zip(kept["cuda"], kept["cpu"]))
    pred = card.predict(X)
    ref = kmeans._assign(Xc, torch.as_tensor(card.centers))
    pred_rows = np.flatnonzero(pred != ref[0].numpy())
    pred_flips = _tie_rows(X, card.centers, pred_rows)
    inertia = card.inertia(X)
    cpu_inertia = float(torch.sum(ref[1] ** 2))
    row = {"points": len(X), "features": X.shape[1], "k": APPS_K,
           "iterations": card.iterations_done,
           "iterations_cpu": cpu.iterations_done,
           "seeding_s": seed_s[0], "fit_s": t_end - t0, "cpu_fit_s": cpu_s,
           "assign_device_ms": _mean(assign_ms),
           "assign_device_ms_each": [round(v, 4) for v in assign_ms],
           "update_host_ms": _mean(updates_ms),
           "cluster_sizes": np.bincount(pred, minlength=APPS_K).tolist(),
           "tie_flips": flips[:20], "n_tie_flips": len(flips),
           "predict_flips": pred_flips[:20],
           "same_path_as_cpu": same,
           "centers_bitwise": bool(np.array_equal(card.centers, cpu.centers)),
           "centers_max_abs_diff": float(np.abs(card.centers
                                                - cpu.centers).max()),
           "inertia": inertia, "inertia_cpu_same_centers": cpu_inertia,
           "inertia_rel": abs(inertia - cpu_inertia) / cpu_inertia,
           "checks_s": time.perf_counter() - t_check}
    bad = [f for f in flips + pred_flips if not f["tie"]]
    if bad or n_card != card.iterations_done:
        raise AssertionError(f"phase 20 (a): assignments differ beyond ties "
                             f"{bad[:5]} ({n_card} assignments)")
    if same and not (row["centers_bitwise"]
                     and card.iterations_done == cpu.iterations_done):
        raise AssertionError("phase 20 (a): the same assignments gave "
                             "other centers")
    if not same and not flips:
        raise AssertionError("phase 20 (a): the card's and the CPU's fits "
                             "parted with no tie row")
    if row["inertia_rel"] > APPS_TOL:
        raise AssertionError(f"phase 20 (a): inertia {inertia} against "
                             f"{cpu_inertia}")
    return row


def _repulsion_rows_f64(Y, rows, chunk=256):
    """frep[rows] of the t-SNE kernel against every point, in f64 on the
    CPU (a plain evaluation, no tiling)."""
    Y = torch.as_tensor(Y, dtype=torch.float64)
    rows = torch.as_tensor(rows)
    out = []
    for c0 in range(0, len(rows), chunk):
        r = rows[c0:c0 + chunk]
        d2 = ((Y[r, None, :] - Y[None, :, :]) ** 2).sum(-1)
        num = 1.0 / (1.0 + d2)
        num[torch.arange(len(r)), r] = 0.0
        n2 = num * num
        out.append(Y[r] * n2.sum(1)[:, None] - n2 @ Y)
    return torch.cat(out).numpy()


def _attraction_rows_f64(Y, src, dst, p, rows):
    """The attraction of the edge list (src, dst, p) at `rows`, in f64
    numpy, from the edges that touch those rows."""
    on = np.zeros(len(Y), bool)
    on[rows] = True
    touch = on[src] | on[dst]
    src, dst, p = src[touch], dst[touch], p[touch].astype(np.float64)
    Y = Y.astype(np.float64)
    dy = Y[src] - Y[dst]
    f_e = (p / (1.0 + (dy * dy).sum(1)))[:, None] * dy
    fatt = np.stack([np.bincount(src, f_e[:, c], len(Y))
                     - np.bincount(dst, f_e[:, c], len(Y))
                     for c in range(Y.shape[1])], 1)
    return fatt[rows]


def apps_exact(X):
    """(b): BarnesHutTsne(theta=0) at 70,000 points: the affinity graph on
    the card, one tile of it held against the CPU, one gradient
    evaluation's sampled rows against the CPU (repulsion and gradient)
    and its Z against f64, with its peak memory, then APPS_EXACT_ITERS
    iterations."""
    from deeplearning4j_tpu_torch.manifold import BarnesHutTsne, bhtsne
    n, dev = len(X), torch.device("cuda")
    est = BarnesHutTsne(theta=0.0, perplexity=APPS_PERPLEXITY,
                        tile_rows=APPS_TILE, max_iter=APPS_EXACT_ITERS,
                        use_pca_init=APPS_PCA_INIT)
    edges = []
    build = est._build_sparse_p

    def keep_edges(*args):
        edges.append(build(*args))
        return edges[-1]
    est._build_sparse_p = keep_edges
    aff_s = _timed_method(est, "_build_sparse_p")
    init_s = _timed_method(est, "_init_embedding")
    patches = []
    spy = _spy(patches, bhtsne, "_tiled_forces", cuda=True)
    try:
        t0 = time.perf_counter()
        Y = est.fit_transform(X)
        fit_s = time.perf_counter() - t0
    finally:
        _restore(patches)
    forces_ms = spy.device_ms()
    src, dst, vals = edges[0]
    k = len(dst) // n
    loop_s = fit_s - aff_s[0] - init_s[0]
    row = {"points": n, "k": k, "edges": len(dst),
           "affinity_s": aff_s[0], "init_s": init_s[0],
           "iterations": APPS_EXACT_ITERS,
           "iteration_ms": loop_s / APPS_EXACT_ITERS * 1e3,
           "forces_device_ms": _mean(forces_ms),
           "kl_history": est.kl_history_}
    if Y.shape != (n, 2) or not np.all(np.isfinite(Y)) or not all(
            np.isfinite(est.kl_history_)):
        raise AssertionError(f"phase 20 (b): embedding {Y.shape}, KL "
                             f"{est.kl_history_}")

    # one tile of the affinity graph against the CPU
    t_check = time.perf_counter()
    t = n // APPS_TILE // 2
    r0, r1 = t * APPS_TILE, (t + 1) * APPS_TILE
    cpu_idx, cpu_p = bhtsne._knn_affinity_tile(
        torch.as_tensor(X), torch.arange(r0, r1), k,
        np.float32(np.log(APPS_PERPLEXITY)))
    cpu_idx, cpu_p = cpu_idx.numpy(), cpu_p.numpy()
    card_idx = dst.reshape(n, k)[r0:r1]
    card_p = vals.reshape(n, k)[r0:r1] * (2.0 * n)
    differ, p_err = [], 0.0
    for i in range(r1 - r0):
        if set(card_idx[i]) != set(cpu_idx[i]):
            x = X[r0 + i]
            d = ((x.astype(np.float64) - X) ** 2).sum(1)
            d[r0 + i] = np.inf
            order = np.argsort(d)
            a, b = order[k - 1], order[k]       # the k-th and (k+1)-th
            differ.append({"row": r0 + i, "kth": float(d[a]),
                           "next": float(d[b]),
                           "rel_tie": bool(d[b] - d[a] <= APPS_TOL * d[b]),
                           "tie": _rounding_tie(x, X[a], X[b])})
            continue
        mine = dict(zip(card_idx[i], card_p[i]))
        p_err = max(p_err, float(np.abs(np.asarray(
            [mine[j] for j in cpu_idx[i]]) - cpu_p[i]).max()))
    row["tile"] = {"rows": [r0, r1], "p_max_abs_err": p_err,
                   "differing_rows": differ}
    if p_err > APPS_TOL or any(not d["rel_tie"] for d in differ):
        raise AssertionError(f"phase 20 (b): the card's affinity tile "
                             f"against the CPU: {row['tile']}")

    row["tile"]["seconds"] = time.perf_counter() - t_check
    # one gradient evaluation at the fitted Y: memory, Z in f64, rows
    t_check = time.perf_counter()
    pad = (-n) % APPS_TILE
    Yp = np.concatenate([Y, np.full((pad, 2), 1e6, np.float32)])
    Yd = torch.as_tensor(Yp, device=dev)
    e_src, e_dst, e_p = (torch.as_tensor(a, device=dev)
                         for a in (src, dst, vals))
    n_tiles = len(Yp) // APPS_TILE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    grad, _ = bhtsne._tiled_forces(Yd, e_src, e_dst, n_tiles, e_p, n)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    frep, z = bhtsne._tiled_repulsion(Yd, n_tiles, n)
    _, z64 = bhtsne._tiled_repulsion(Yd.double(), n_tiles, n)
    z, z64 = float(z), float(z64)
    rows = np.sort(np.random.RandomState(2020).choice(
        n, APPS_SAMPLED_ROWS, replace=False))
    cpu_frep = _repulsion_rows_f64(Y, rows)
    frep_err = float(np.abs(frep[torch.as_tensor(rows, device=dev)]
                            .cpu().numpy() - cpu_frep).max()
                     / np.abs(cpu_frep).max())
    cpu_grad = 4.0 * (_attraction_rows_f64(Y, src, dst, vals, rows)
                      - cpu_frep / z64)
    grad_err = float(np.abs(grad[torch.as_tensor(rows, device=dev)]
                            .cpu().numpy() - cpu_grad).max()
                     / np.abs(cpu_grad).max())
    n2_bytes = 4 * n * n
    row["gradient"] = {"peak_bytes": int(peak), "n2_f32_bytes": n2_bytes,
                       "peak_share_of_n2": peak / n2_bytes,
                       "z": z, "z_f64": z64, "z_rel": abs(z - z64) / z64,
                       "sampled_rows": APPS_SAMPLED_ROWS,
                       "repulsion_rel_err": frep_err,
                       "grad_rel_err": grad_err,
                       "seconds": time.perf_counter() - t_check}
    del grad, frep, Yd, e_src, e_dst, e_p
    torch.cuda.empty_cache()
    g = row["gradient"]
    if (peak >= APPS_MEMORY_SHARE * n2_bytes or g["z_rel"] > APPS_TOL
            or frep_err > APPS_TOL or grad_err > APPS_TOL):
        raise AssertionError(f"phase 20 (b): one gradient evaluation: {g}")
    return row, Y, z64


def apps_barnes_hut(X, Y_exact, z_exact, exact):
    """(c): BarnesHutTsne(theta=0.5) at 70,000 points: the affinity on the
    card, APPS_BH_ITERS host iterations through the native sp-tree; its
    Z at (b)'s Y against (b)'s exact Z; BH against the exact pass at
    70,000 and 10,000 points."""
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.manifold import BarnesHutTsne, bhtsne
    from deeplearning4j_tpu_torch.manifold.sptree import bh_repulsion
    if not native.available():
        raise AssertionError("phase 20 (c): the native library is not "
                             f"available on the card machine: "
                             f"{native.BUILD_INFO}")
    n = len(X)
    est = BarnesHutTsne(theta=0.5, perplexity=APPS_PERPLEXITY,
                        tile_rows=APPS_TILE, max_iter=APPS_BH_ITERS,
                        use_pca_init=APPS_PCA_INIT)
    aff_s = _timed_method(est, "_build_sparse_p")
    init_s = _timed_method(est, "_init_embedding")
    native.reset_calls()
    t0 = time.perf_counter()
    Y = est.fit_transform(X)
    fit_s = time.perf_counter() - t0
    calls = native.CALLS["bh_repulsion_f32"]
    loop_s = fit_s - aff_s[0] - init_s[0]

    def host_ms(fn, reps):
        took = []
        for _ in range(reps):
            t = time.perf_counter()
            fn()
            took.append((time.perf_counter() - t) * 1e3)
        return statistics.median(took)
    _, z_bh, visits = bh_repulsion(Y_exact, 0.5)
    bh70 = host_ms(lambda: bh_repulsion(Y_exact, 0.5), 3)
    Y10 = np.ascontiguousarray(Y_exact[:APPS_SMALL])
    bh10 = host_ms(lambda: bh_repulsion(Y10, 0.5), 5)
    dev = torch.device("cuda")
    e0 = torch.zeros(1, dtype=torch.int64, device=dev)
    p0 = torch.zeros(1, device=dev)
    Y10d = torch.as_tensor(Y10, device=dev)
    exact10 = cuda_ms(lambda: bhtsne._tiled_forces(
        Y10d, e0, e0, APPS_SMALL // 1000, p0, APPS_SMALL), iters=10)
    row = {"points": n, "theta": 0.5, "affinity_s": aff_s[0],
           "init_s": init_s[0], "iterations": APPS_BH_ITERS,
           "native_bh_calls": calls, "iteration_ms": loop_s
           / APPS_BH_ITERS * 1e3, "kl_history": est.kl_history_,
           "cells_visited": est.cells_visited_,
           "z_bh_at_exact_y": z_bh, "z_exact": z_exact,
           "z_rel": abs(z_bh - z_exact) / z_exact,
           "visits_at_exact_y": visits,
           "repulsion_ms": {"bh_host_70k": bh70,
                            "exact_card_70k": exact["forces_device_ms"],
                            "bh_host_10k": bh10,
                            "exact_card_10k": exact10},
           "iteration_ms_exact_70k": exact["iteration_ms"]}
    row["faster_at_10k"] = "bh" if bh10 < exact10 else "exact"
    row["faster_at_70k"] = "bh" if bh70 < exact["forces_device_ms"] \
        else "exact"
    if calls != APPS_BH_ITERS or not hasattr(est, "cells_visited_"):
        raise AssertionError(f"phase 20 (c): {calls} native bh_repulsion "
                             f"calls, expected {APPS_BH_ITERS}")
    if Y.shape != (n, 2) or not np.all(np.isfinite(Y)) or not all(
            np.isfinite(est.kl_history_)):
        raise AssertionError(f"phase 20 (c): embedding {Y.shape}, KL "
                             f"{est.kl_history_}")
    if row["z_rel"] >= APPS_BH_Z_REL:
        raise AssertionError(f"phase 20 (c): BH Z {z_bh} against exact "
                             f"{z_exact}")
    return row


def apps_tsne(X, labels):
    """(d): the exact Tsne at 10,000 points, all 500 default iterations on
    the card: sampled rows of the conditional P and the first 3 gradients
    against the CPU, the label purity of the nearest embedded neighbour,
    ms an iteration and peak memory."""
    from deeplearning4j_tpu_torch.manifold import Tsne, tsne
    Xs, ls = X[:APPS_SMALL], labels[:APPS_SMALL]
    seen, P, cond = [], [], []
    rows = np.sort(np.random.RandomState(2021).choice(
        APPS_SMALL, APPS_P_ROWS, replace=False))
    rows_d = torch.as_tensor(rows, device="cuda")

    def keep(args, out):
        if len(seen) < 3:
            if not P:
                P.append(args[1].cpu())
            seen.append((args[0].cpu(), out[0].cpu()))
    patches = []
    grad_spy = _spy(patches, tsne, "_tsne_grad", keep=keep)
    joint = _spy(patches, tsne, "_joint_p", sync=True)
    _spy(patches, tsne, "_binary_search_perplexity",
         keep=lambda args, out: cond.append(out[rows_d].cpu()))
    init = _spy(patches, tsne, "_init_embedding")
    est = Tsne()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    try:
        t0 = time.perf_counter()
        Y = est.fit_transform(Xs)
        fit_s = time.perf_counter() - t0
    finally:
        _restore(patches)
    peak = torch.cuda.max_memory_allocated() - base
    t_check = time.perf_counter()
    # the conditional P of the sampled rows as _joint_p computes it
    X64 = torch.as_tensor(Xs, dtype=torch.float64)
    d2 = tsne._sqdist(X64[rows], X64).float()
    d2[torch.arange(len(rows)), torch.as_tensor(rows)] = 1e12
    cond_cpu = tsne._binary_search_perplexity(
        d2, np.log(est.perplexity))
    del X64, d2
    cond_err = float((cond[0] - cond_cpu).abs().max()
                     / cond_cpu.abs().max())
    Pj = P[0].double() / est.early_exaggeration
    p_sum, p_asym = float(Pj.sum()), float((Pj - Pj.T).abs().max()
                                           / Pj.abs().max())
    errs = []
    for Yi, g_card in seen:
        g_cpu = tsne._tsne_grad(Yi, P[0])[0]
        errs.append(float((g_card - g_cpu).abs().max() / g_cpu.abs().max()))
    del P, Pj, seen, cond
    Yt = torch.as_tensor(Y, device="cuda")
    d2 = tsne._embed_sqdist(Yt, Yt)
    d2.fill_diagonal_(float("inf"))
    nearest = d2.argmin(1).cpu().numpy()
    del d2, Yt
    torch.cuda.empty_cache()
    purity = float((ls[nearest] == ls).mean())
    loop_s = fit_s - joint.host_s() - init.host_s()
    row = {"points": APPS_SMALL, "iterations": est.max_iter,
           "joint_p_s": joint.host_s(), "init_s": init.host_s(),
           "iteration_ms": loop_s / est.max_iter * 1e3,
           "grad_calls": len(grad_spy.entries),
           "conditional_p_rows": APPS_P_ROWS,
           "conditional_p_rel_err": cond_err, "p_sum": p_sum,
           "p_asymmetry": p_asym,
           "first_grads_rel_err": errs, "purity": purity,
           "checks_s": time.perf_counter() - t_check,
           "kl": est.kl_divergence_, "peak_bytes": int(peak),
           "fit_s": fit_s}
    if (max(errs) > APPS_TOL or cond_err > APPS_TOL
            or abs(p_sum - 1.0) > APPS_TOL or p_asym > APPS_TOL
            or purity <= APPS_PURITY or not np.all(np.isfinite(Y))):
        raise AssertionError(f"phase 20 (d): {row}")
    return row


def apps_neighbours(X, Y_exact):
    """(e): the nearest-neighbours server over a 71,290 x 300 table, exact
    against a brute force on the card before and after a rebuild; LSH's
    recall@10; a KD-tree over (b)'s embedding; random projection's
    distortion."""
    from deeplearning4j_tpu_torch.clustering import (
        KDTree, NearestNeighborsClient, NearestNeighborsServer,
        RandomProjection, RandomProjectionLSH,
    )
    dev = torch.device("cuda")
    rs = np.random.RandomState(2020)
    T = rs.randn(NN_ROWS, NN_DIM).astype(np.float32)

    def brute(table_d, q, k=NN_K):
        d = torch.sqrt(((table_d - torch.as_tensor(
            q, dtype=torch.float64, device=dev)) ** 2).sum(1))
        v, i = torch.topk(d, k, largest=False)
        return i.cpu().numpy().tolist(), v.cpu().numpy()

    wrong = []

    def check(res, table_d, q, what):
        bi, bd = brute(table_d, q)
        idx = [r["index"] for r in res]
        dist = np.asarray([r["distance"] for r in res])
        if idx != bi or np.any(np.abs(dist - bd)
                               > APPS_TOL * np.maximum(bd, 1.0)):
            wrong.append({"what": what, "got": idx, "brute": bi})
        return bi

    Td = torch.as_tensor(T, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    server = NearestNeighborsServer(T, port=0)
    build_s = time.perf_counter() - t0
    lat, brute_of = [], []
    with server:
        client = NearestNeighborsClient(port=server.port)
        queries = rs.randn(NN_NEW, NN_DIM).astype(np.float32)
        for i, q in enumerate(queries):
            t = time.perf_counter()
            res = client.knn_new(q, k=NN_K)
            lat.append((time.perf_counter() - t) * 1e3)
            brute_of.append(check(res, Td, q, f"knnnew {i}"))
        indexed = rs.choice(NN_ROWS, NN_INDEXED, replace=False)
        for i in indexed:
            t = time.perf_counter()
            res = client.knn(int(i), k=NN_K)
            lat.append((time.perf_counter() - t) * 1e3)
            brute_of.append(check(res, Td, T[i], f"knn {i}"))
        V = rs.randn(NN_INSERTS, NN_DIM).astype(np.float32)
        ins_ms, ids = [], []
        for v in V:
            t = time.perf_counter()
            ids.append(client.insert(v))
            ins_ms.append((time.perf_counter() - t) * 1e3)
        rebuilt = not server._extra and len(server.points) == \
            NN_ROWS + NN_INSERTS
        T2d = torch.cat([Td, torch.as_tensor(V, dtype=torch.float64,
                                              device=dev)])
        after = []
        for j in range(NN_AFTER):
            q = (V[j] + 0.1 * rs.randn(NN_DIM)).astype(np.float32)
            t = time.perf_counter()
            res = client.knn_new(q, k=NN_K)
            after.append((time.perf_counter() - t) * 1e3)
            check(res, T2d, q, f"knnnew after rebuild {j}")
        res = client.knn(NN_ROWS + 7, k=NN_K)
        check(res, T2d, V[7], "knn of an inserted point")
        health = client.health()
    del Td, T2d
    torch.cuda.empty_cache()
    row = {"table": [NN_ROWS, NN_DIM], "k": NN_K, "build_s": build_s,
           "queries": len(lat), "query_p50_ms": statistics.median(lat),
           "queries_s": sum(lat) / 1e3, "inserts_s": sum(ins_ms) / 1e3,
           "query_max_ms": max(lat), "inserts": NN_INSERTS,
           "insert_p50_ms": statistics.median(ins_ms),
           "rebuild_s": max(ins_ms) / 1e3, "rebuilt": rebuilt,
           "after_rebuild_p50_ms": statistics.median(after),
           "health": health, "wrong": wrong}
    if wrong or not rebuilt or ids != list(range(NN_ROWS, NN_ROWS
                                                 + NN_INSERTS)) \
            or health["points"] != NN_ROWS + NN_INSERTS:
        raise AssertionError(f"phase 20 (e): {row}")

    t0 = time.perf_counter()
    lsh = RandomProjectionLSH(LSH_BITS, LSH_TABLES, seed=0).fit(T)
    lsh_s = time.perf_counter() - t0
    qs = list(queries) + [T[i] for i in indexed]
    recall = [len(set(lsh.query(q, NN_K)[0]) & set(b)) / NN_K
              for q, b in zip(qs, brute_of)]
    row["lsh"] = {"bits": LSH_BITS, "tables": LSH_TABLES, "fit_s": lsh_s,
                  "recall_at_10_new": _mean(recall[:NN_NEW]),
                  "recall_at_10_indexed": _mean(recall[NN_NEW:])}

    t0 = time.perf_counter()
    kd = KDTree(Y_exact)
    kd_build = time.perf_counter() - t0
    # a neighbourhood query is an embedded point, moved by 1 % of the
    # embedding's spread
    kq = (Y_exact[rs.choice(len(Y_exact), KD_QUERIES, replace=False)]
          + 0.01 * Y_exact.std(0) * rs.randn(KD_QUERIES, 2)
          ).astype(np.float32)
    Yd = torch.as_tensor(Y_exact, dtype=torch.float64, device=dev)
    kd_wrong, kd_ties, took = [], [], []
    for q in kq:
        t = time.perf_counter()
        idx, dist = kd.knn(q, NN_K)
        took.append((time.perf_counter() - t) * 1e3)
        bi, bd = brute(Yd, q, NN_K + 1)
        extra = set(idx) - set(bi[:NN_K])
        # a neighbour past the k-th must tie the k-th (f32 distances)
        tie = all(i == bi[NN_K] for i in extra) and \
            bd[NN_K] - bd[NN_K - 1] <= APPS_TOL * bd[NN_K]
        if (extra and not tie) or np.any(
                np.abs(np.sort(dist) - bd[:NN_K])
                > APPS_TOL * np.maximum(bd[:NN_K], 1e-3)):
            kd_wrong.append({"query": q.tolist(), "got": idx, "brute": bi})
        elif extra:
            kd_ties.append({"query": q.tolist(), "kth": float(bd[NN_K - 1]),
                            "next": float(bd[NN_K])})
    del Yd
    row["kdtree"] = {"points": len(Y_exact), "build_s": kd_build,
                     "queries": KD_QUERIES,
                     "query_ms": statistics.median(took), "wrong": kd_wrong,
                     "ties": kd_ties}

    t0 = time.perf_counter()
    Z = RandomProjection(RP_DIM, seed=0).fit(X).transform(X)
    rp_s = time.perf_counter() - t0
    pairs = rs.randint(0, len(X), (RP_PAIRS, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    dx = np.linalg.norm(X[pairs[:, 0]] - X[pairs[:, 1]], axis=1)
    dz = np.linalg.norm(Z[pairs[:, 0]] - Z[pairs[:, 1]], axis=1)
    ratio = dz / dx
    row["random_projection"] = {
        "dims": [X.shape[1], RP_DIM], "seconds": rp_s,
        "pairs": len(pairs), "ratio_mean": float(ratio.mean()),
        "ratio_std": float(ratio.std()), "ratio_min": float(ratio.min()),
        "ratio_max": float(ratio.max())}
    if kd_wrong or not np.all(np.isfinite(ratio)):
        raise AssertionError(f"phase 20 (e): KD-tree {kd_wrong[:3]}")
    return row


def apps_dashboard(Y, labels):
    """(f): (b)'s embedding posted to the dashboard's t-SNE view and read
    back over HTTP."""
    from deeplearning4j_tpu_torch.ui.server import UIServer
    ui = UIServer(port=0)
    try:
        t0 = time.perf_counter()
        ui.post_tsne("apps", Y, labels)
        status, body = _get_json(
            f"http://127.0.0.1:{ui.port}/tsne/coords/apps")
        seconds = time.perf_counter() - t0
    finally:
        ui.stop()
    pts = body.get("points", [])
    same = status == 200 and len(pts) == len(Y) and np.array_equal(
        np.asarray([p[:2] for p in pts], np.float64),
        Y.astype(np.float64)) and [p[2] for p in pts] == [
        str(v) for v in labels]
    row = {"points": len(pts), "status": status, "equal": bool(same),
           "seconds": seconds}
    if not same:
        raise AssertionError(f"phase 20 (f): {row}")
    return row


def apps(fa, gpu):
    """Phase 20: clustering and manifold learning at full size."""
    import os
    from deeplearning4j_tpu_torch import native
    t_phase = time.perf_counter()
    row = {"phase": "apps", "gpu": gpu}
    omp = getattr(native.get_lib().cdll, "omp_get_max_threads", None) \
        if native.available() else None
    row["host"] = {"loadavg": os.getloadavg(),
                   "torch_threads": torch.get_num_threads(),
                   "native_omp_threads": omp() if omp else None}
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    X, labels = apps_data()
    row["data_s"] = time.perf_counter() - t0
    parts = (("kmeans", lambda: apps_kmeans(X)),
             ("exact", lambda: apps_exact(X)),
             ("barnes_hut", lambda: apps_barnes_hut(
                 X, Y_exact, z_exact, row["exact"])),
             ("tsne", lambda: apps_tsne(X, labels)),
             ("neighbours", lambda: apps_neighbours(X, Y_exact)),
             ("dashboard", lambda: apps_dashboard(Y_exact, labels)))
    Y_exact = z_exact = None
    for name, run in parts:
        t0 = time.perf_counter()
        out = run()
        if name == "exact":
            out, Y_exact, z_exact = out
        row[name] = dict(out, seconds=time.perf_counter() - t0)
        emit({"phase": f"apps_{name}", "gpu": gpu, **row[name]})
    row["flash_launches"] = dict(fa.KERNEL_LAUNCHES)
    if any(row["flash_launches"].values()):
        raise AssertionError(f"phase 20 launched flash kernels: "
                             f"{row['flash_launches']}")
    row["seconds"] = time.perf_counter() - t_phase
    row["budget_s"] = APPS_BUDGET_S
    emit({k: v for k, v in row.items() if k not in dict(parts)})
    if row["seconds"] > APPS_BUDGET_S:
        raise AssertionError(f"phase 20 took {row['seconds']:.1f} s "
                             f"> {APPS_BUDGET_S}")
    return row



# ------------------------------------------------------- phase 21: scripts
SCRIPTS_BUDGET_S = 45.0
# make_shards' input: seeded PNGs in class directories, at ImageNet's
# 224² (the tool's default height and width)
SCRIPTS_IMAGES, SCRIPTS_HW, SCRIPTS_CLASSES = 256, 224, 4
#: the examples the phase runs, at tests/test_examples.py's reduced
#: settings, each with the JAX example's result check there
SCRIPTS_EXAMPLES = (
    ("01_quickstart_mlp", dict(epochs=15), "accuracy > 0.9",
     lambda r: r > 0.9),
    ("03_cnn_digits", dict(epochs=2), "holdout accuracy > 0.7",
     lambda r: r > 0.7),
    ("04_char_lstm", dict(epochs=30, units=32), "41 characters sampled",
     lambda r: len(r) == 41),
    ("13_custom_layer", dict(epochs=30), "accuracy > 0.9",
     lambda r: r > 0.9),
    ("14_long_context_ring", dict(epochs=4),
     "the score falls (asserted in the example)",
     lambda r: math.isfinite(r)),
)
_KEEP_DIR: list = []


def keep_file(path, name):
    """A copy of `path` in the run's keep directory (a phase's temporary
    directory goes with the phase): the files a later phase reads."""
    import shutil
    if not _KEEP_DIR:
        _KEEP_DIR.append(tempfile.mkdtemp(prefix="chip_smoke_keep_"))
    dst = os.path.join(_KEEP_DIR[0], name)
    shutil.copyfile(path, dst)
    return dst


def _captured(fn, *args):
    """(fn(*args), its stdout): a tool's report line kept for the row."""
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _seeded_image_tree(root):
    """SCRIPTS_IMAGES seeded RGB PNGs of SCRIPTS_HW², SCRIPTS_CLASSES class
    directories (the ImageRecordReader layout make_shards reads)."""
    from PIL import Image
    rs = np.random.RandomState(21)
    for i in range(SCRIPTS_IMAGES):
        d = os.path.join(root, f"class{i % SCRIPTS_CLASSES}")
        os.makedirs(d, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (SCRIPTS_HW, SCRIPTS_HW, 3),
                                   dtype=np.uint8)).save(
            os.path.join(d, f"{i:04d}.png"), compress_level=1)


def scripts(fa, gpu, tmp):
    """Phase 21: the user scripts on the card (the examples and tools
    under deeplearning4j_tpu_torch/{examples,tools})."""
    import importlib
    import shutil

    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.tools import (
        etl_smoke, flash_smoke, make_shards, serve_smoke, trace_report,
    )
    t_phase = time.perf_counter()
    row = {"phase": "scripts", "gpu": gpu}

    # (a) flash_smoke: the three kernels against their plain versions
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    rep, _ = _captured(flash_smoke.run, "cuda")
    row["flash_smoke"] = {
        "seconds": time.perf_counter() - t0, "ok": rep["ok"],
        "failures": rep["failures"], "launches": rep["launches"],
        "cases": [{k: c.get(k) for k in ("kind", "case", "dtype",
                                         "max_abs_err", "tol", "ok", "ms",
                                         "plain_ms")}
                  for c in rep["cases"]]}
    emit({"phase": "scripts_flash_smoke", "gpu": gpu, **row["flash_smoke"]})
    if not rep["ok"] or not all(rep["launches"][k] > 0 for k in KERNELS):
        raise AssertionError(f"flash_smoke: {rep['failures']} "
                             f"{rep['launches']}")

    # the scripts' own path from here: the counts from 0
    for k in KERNELS:
        fa.KERNEL_LAUNCHES[k] = 0
    # (b) make_shards over seeded images, then etl_smoke reading them
    t0 = time.perf_counter()
    imgs, shards = os.path.join(tmp, "images"), os.path.join(tmp, "shards")
    _seeded_image_tree(imgs)
    made_s = time.perf_counter() - t0
    rc, out = _captured(make_shards.main, [
        "--out", shards, "--image-dir", imgs, "--height", str(SCRIPTS_HW),
        "--width", str(SCRIPTS_HW), "--channels", "3", "--shuffle-seed",
        "0", "--verify"])
    shard_rep = json.loads(out.strip().splitlines()[-1])
    if rc != 0 or shard_rep["n_records"] != SCRIPTS_IMAGES \
            or shard_rep["verified"] is not True:
        raise AssertionError(f"make_shards: {rc} {shard_rep}")
    row["make_shards"] = dict(shard_rep, images_written_s=made_s,
                              seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    etl, _ = _captured(etl_smoke.run, "cuda", shards)
    row["etl_smoke"] = dict(etl, seconds=time.perf_counter() - t0)
    if not etl["ok"]:
        raise AssertionError(f"etl_smoke: {etl}")
    emit({"phase": "scripts_data", "gpu": gpu,
          "make_shards": row["make_shards"], "etl_smoke": row["etl_smoke"]})

    # (c) serve_smoke, traced: its spans are the second trace segment
    _telemetry_reset()
    monitor.enable_tracing()
    t0 = time.perf_counter()
    rc, out = _captured(serve_smoke.main, ["--device", "cuda"])
    seg = os.path.join(tmp, "serve_smoke.json")
    monitor.save_trace(seg)
    _telemetry_reset()
    serve_rep = json.loads(out[out.index("{"):])
    row["serve_smoke"] = dict(serve_rep, seconds=time.perf_counter() - t0)
    emit({"phase": "scripts_serve_smoke", "gpu": gpu, **row["serve_smoke"]})
    if rc != 0:
        raise AssertionError(f"serve_smoke: {serve_rep['failures']}")

    # (d) trace_report: phase 12's server segment and (c)'s, one process
    # of the same pid, merged onto two tracks; one request's spans
    t0 = time.perf_counter()
    tele = os.path.join(_KEEP_DIR[0], "telemetry_serve.json") \
        if _KEEP_DIR else None
    if tele is None or not os.path.exists(tele):
        raise AssertionError("phase 12 left no serve trace segment")
    with open(tele) as f:
        tids = [e["args"]["trace_id"] for e in json.load(f)["traceEvents"]
                if e.get("ph") == "X" and (e.get("args") or {}).get(
                    "trace_id")]
    merged = os.path.join(tmp, "merged.json")
    rc, out = _captured(trace_report.main, [
        "--out", merged, f"telemetry={tele}", f"serve_smoke={seg}",
        "--trace-id", tids[0]])
    full = trace_report.merge_trace_files([("telemetry", tele),
                                           ("serve_smoke", seg)])
    tracks = [e for e in full["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "process_name"]
    with open(merged) as f:
        picked = trace_report.events_for_trace(json.load(f), tids[0])
    row["trace_report"] = {
        "segments": 2, "events": len(full["traceEvents"]),
        "process_tracks": len(tracks), "trace_id": tids[0],
        "trace_spans": len(picked), "summary": out.strip().splitlines(),
        "seconds": time.perf_counter() - t0}
    if rc != 0 or len(tracks) < 2 or not picked:
        raise AssertionError(f"trace_report: {rc} {row['trace_report']}")
    shutil.rmtree(_KEEP_DIR.pop(), ignore_errors=True)

    # (e) the examples, each held to the JAX example's result
    row["examples"] = {}
    for name, kw, want, check in SCRIPTS_EXAMPLES:
        mod = importlib.import_module(
            f"deeplearning4j_tpu_torch.examples.{name}")
        if "tmpdir" in mod.main.__code__.co_varnames:
            kw = dict(kw, tmpdir=tmp)
        before = dict(fa.KERNEL_LAUNCHES)
        t0 = time.perf_counter()
        result, _ = _captured(lambda: mod.main(device="cuda", **kw))
        secs = time.perf_counter() - t0
        ex = {"result": result if isinstance(result, (int, float, str))
              else float(result), "check": want, "ok": bool(check(result)),
              "seconds": secs, "kwargs": kw,
              "flash_launches": {k: fa.KERNEL_LAUNCHES[k] - before[k]
                                 for k in KERNELS}}
        row["examples"][name] = ex
        emit({"phase": "scripts_example", "gpu": gpu, "example": name,
              **ex})
        if not ex["ok"]:
            raise AssertionError(f"example {name}: {result!r} ({want})")
    row["launches"] = dict(fa.KERNEL_LAUNCHES)
    if not all(row["launches"][k] > 0 for k in KERNELS):
        raise AssertionError(f"a kernel of the scripts path never "
                             f"launched: {row['launches']}")
    row["seconds"] = time.perf_counter() - t_phase
    row["budget_s"] = SCRIPTS_BUDGET_S
    emit({k: v for k, v in row.items()
          if k not in ("flash_smoke", "etl_smoke", "make_shards",
                       "serve_smoke", "examples")})
    if row["seconds"] > SCRIPTS_BUDGET_S:
        raise AssertionError(f"phase 21 took {row['seconds']:.1f} s "
                             f"> {SCRIPTS_BUDGET_S}")
    return {"launches": row["launches"],
            "flash_smoke_launches": row["flash_smoke"]["launches"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only (no timing, no "
                         "serving)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import os
    from deeplearning4j_tpu_torch.ops import _build
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.util.platform import set_f32_matmul_exact
    set_f32_matmul_exact()
    os.environ["DL4J_CUDA_ZIP_STORED"] = "1"    # inherited by subprocesses

    gpu = gpu_line()
    print(gpu, flush=True)
    emit({"phase": "device", "gpu": gpu,
          "kind": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    built = run_phase("build", _build.build_all)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [{"name": b.name, "nvcc_s": b.seconds,
                         "ptxas": ptxas_report(b.log)} for b in built]})

    host_reading("kernels", "start")
    errs = check_kernel_cases(fa)
    check_fwd_determinism(fa)
    bwd_errs = check_bwd_cases(fa)
    check_bwd_determinism(fa)
    host_reading("kernels", "end")
    if args.quick:
        return 0
    host_reading("kernel_time", "start")
    bench = time_attention(fa, 4, 2048, 8, 64, torch.bfloat16, gpu)
    main_row = time_attention(fa, 4, SEQ, HEADS, HEAD_DIM, torch.float32, gpu)
    bwd_bench = time_backward(fa, 4, 2048, 8, 64, torch.bfloat16, gpu)
    bwd_main = time_backward(fa, 4, SEQ, HEADS, HEAD_DIM, torch.float32, gpu)
    host_reading("kernel_time", "end")
    serve_launches = run_phase("serve", serve, fa)
    gen_launches = run_phase("generate", generate,
                         fa)["request_path_flash_launches"]
    trained = run_phase("train", train, fa, tmp=True)
    resnet_run = run_phase("resnet", resnet, fa, tmp=True)
    graph_run = run_phase("fit_graph", fit_graph, fa, tmp=True)
    rnn_run = run_phase("rnn", rnn, fa, tmp=True)
    zoo_run = run_phase("zoo", zoo, fa, tmp=True)
    lm_ops_run = run_phase("lm_ops", lm_ops, fa, tmp=True)
    data_run = run_phase("data_plane", data_plane, fa, tmp=True)
    tele_run = run_phase("telemetry", telemetry, fa, tmp=True)
    res_run = run_phase("resilience", resilience, fa, tmp=True)
    fleet_run = run_phase("fleet", fleet, fa, tmp=True)
    par_run = run_phase("parallel", parallel, fa, tmp=True)
    seq_run = run_phase("sequence", sequence, fa, tmp=True)
    nlp_run = run_phase("nlp", nlp, fa, gpu)
    interop_run = run_phase("interop", interop, fa, gpu)
    apps_run = run_phase("apps", apps, fa, gpu)
    scripts_run = run_phase("scripts", scripts, fa, gpu, tmp=True)
    timed = ("kernel_ms", "kernel_device_ms", "plain_ms", "library_ms",
             "library_device_ms", "bound_ms")
    table = [{
        "name": "flash_fwd", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES,
        "launches": trained["launches"]["flash_fwd"],
        "launches_by_path": {"serve": serve_launches,
                             "generate": gen_launches["flash_fwd"],
                             "train": trained["launches"]["flash_fwd"],
                             "resnet": resnet_run["launches"]["flash_fwd"],
                             "train_graph":
                                 graph_run["train_graph"]["flash_fwd"],
                             "rnn": rnn_run["flash_launches"]["flash_fwd"],
                             "zoo": zoo_run["flash_launches"]["flash_fwd"],
                             "lm_ops":
                                 lm_ops_run["flash_launches"]["flash_fwd"],
                             "data_plane":
                                 data_run["flash_launches"]["flash_fwd"],
                             "telemetry":
                                 tele_run["flash_launches"]["flash_fwd"],
                             "resilience":
                                 res_run["flash_launches"]["flash_fwd"],
                             "fleet":
                                 fleet_run["flash_launches"]["flash_fwd"],
                             "parallel":
                                 par_run["flash_launches"]["flash_fwd"],
                             "sequence": seq_run["flash_launches"][
                                 "sequence"]["flash_fwd"],
                             "pipeline": seq_run["flash_launches"][
                                 "pipeline"]["flash_fwd"],
                             "tensor": seq_run["tensor"][
                                 "flash_launches"]["flash_fwd"],
                             "nlp": nlp_run["flash_launches"]["flash_fwd"],
                             "interop": interop_run[
                                 "interop_flash_launches"]["flash_fwd"],
                             "ui": interop_run["flash_launches"][
                                 "flash_fwd"],
                             "apps": apps_run["flash_launches"][
                                 "flash_fwd"],
                             "scripts": scripts_run["launches"][
                                 "flash_fwd"],
                             "flash_smoke": scripts_run[
                                 "flash_smoke_launches"]["flash_fwd"]},
        "max_abs_err": errs["main_path_f32_causal"],
        "ms": main_row["kernel_ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "kernel_device_ms": main_row["kernel_device_ms"],
        "library_device_ms": main_row["library_device_ms"],
        "shape": main_row["shape"], "dtype": main_row["dtype"],
        "bench_shape_bf16": {k: bench[k] for k in timed}}]
    for name, grad in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dk")):
        row = bwd_main[name]
        table.append({
            "name": name, "route": "cuda", "source": BWD_SOURCE,
            "replaces": BWD_REPLACES[name],
            "launches": trained["launches"][name],
            "launches_by_path": {"serve": 0, "generate": gen_launches[name],
                                 "train": trained["launches"][name],
                                 "resnet": resnet_run["launches"][name],
                                 "train_graph": graph_run["train_graph"][name],
                                 "rnn": rnn_run["flash_launches"][name],
                                 "zoo": zoo_run["flash_launches"][name],
                                 "lm_ops":
                                     lm_ops_run["flash_launches"][name],
                                 "data_plane":
                                     data_run["flash_launches"][name],
                                 "telemetry":
                                     tele_run["flash_launches"][name],
                                 "resilience":
                                     res_run["flash_launches"][name],
                                 "fleet":
                                     fleet_run["flash_launches"][name],
                                 "parallel":
                                     par_run["flash_launches"][name],
                                 "sequence": seq_run["flash_launches"][
                                     "sequence"][name],
                                 "pipeline": seq_run["flash_launches"][
                                     "pipeline"][name],
                                 "tensor": seq_run["tensor"][
                                     "flash_launches"][name],
                                 "nlp": nlp_run["flash_launches"][name],
                                 "interop": interop_run[
                                     "interop_flash_launches"][name],
                                 "ui": interop_run["flash_launches"][name],
                                 "apps": apps_run["flash_launches"][name],
                                 "scripts": scripts_run["launches"][name],
                                 "flash_smoke": scripts_run[
                                     "flash_smoke_launches"][name]},
            "max_abs_err": max(bwd_errs["main_path_f32_causal"][g]
                               for g in ((grad,) if grad == "dq"
                                         else ("dk", "dv"))),
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "kernel_device_ms": row["kernel_device_ms"],
            "library_device_ms": row["library_device_ms"],
            "shape": row["shape"], "dtype": row["dtype"],
            "bench_shape_bf16": {k: bwd_bench[name][k] for k in timed}})
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception as e:  # noqa: BLE001 — any phase failing fails the run
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
