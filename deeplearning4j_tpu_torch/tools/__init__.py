"""Drills for the serving fleet, run as modules:

    python -m deeplearning4j_tpu_torch.tools.serve_chaos [--device cuda]
    python -m deeplearning4j_tpu_torch.tools.rollout_drill [--device cuda]

`loadgen` is the closed-loop / ramp load generator both drive traffic
with. Each drill prints a JSON report and exits 0 iff every assertion
held. `stack_sample` runs a program with its main thread's stack
sampled (where `chip_smoke.py` or a replica's start spends its time):

    python -m deeplearning4j_tpu_torch.tools.stack_sample --out S.json \
        chip_smoke.py
    python -m deeplearning4j_tpu_torch.tools.stack_sample --report S.json

`graftlint` runs the port's static analyzer (`analysis/`) over the
port's tree, or with ``--profile jax`` over the reference's:

    python -m deeplearning4j_tpu_torch.tools.graftlint [--json]

The counterparts of the JAX package's other `tools/` runners, by the
same names (each on CUDA unless ``--device cpu``): the converters
`make_shards` and `make_dl4j_fixture` and the trace merger
`trace_report` (host work only); the acceptance runs `etl_smoke`,
`chaos_fit`, `serve_smoke`, `decode_smoke`, `telemetry_smoke` and
`goodput_report`; `flash_smoke` (the flash kernels against their plain
versions); `mfu_probe` and `profile_capture` (the card's reachable peak
and ResNet-50's step). Each says in its docstring how to run it.
"""
