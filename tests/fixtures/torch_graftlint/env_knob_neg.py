"""env-knob-contract near-misses, torch profile: the accessors, writes
that seed child processes, a value compared as a value, and the
reference's DL4J_TPU_ names (not the port's knobs)."""
import os

from deeplearning4j_tpu_torch.util.env import env_flag, env_int, env_str

on = env_flag("DL4J_CUDA_ZIP_STORED", default=False)
k = env_int("DL4J_CUDA_SCAN_STEPS", 1)
os.environ["DL4J_CUDA_ETL_WORKERS"] = "0"
os.environ.setdefault("DL4J_CUDA_ETL_MP_START", "spawn")
schedule = env_str("DL4J_CUDA_FAULTS") == "preempt_at=7"
reference = os.environ.get("DL4J_TPU_SCAN_STEPS")
