"""Drills for the serving fleet, run as modules:

    python -m deeplearning4j_tpu_torch.tools.serve_chaos [--device cuda]
    python -m deeplearning4j_tpu_torch.tools.rollout_drill [--device cuda]

`loadgen` is the closed-loop / ramp load generator both drive traffic
with. Each drill prints a JSON report and exits 0 iff every assertion
held.
"""
