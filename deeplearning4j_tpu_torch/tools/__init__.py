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
"""
