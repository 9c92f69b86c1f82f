"""env-knob-contract, torch profile: raw reads of the port's DL4J_CUDA_
knobs and hand-rolled flag truthiness."""
import os

from deeplearning4j_tpu_torch.util.env import env_str

a = os.environ.get("DL4J_CUDA_FIT_PREFETCH")  # EXPECT
b = os.getenv("DL4J_CUDA_SCAN_STEPS")  # EXPECT
c = os.environ["DL4J_CUDA_DATA_DIR"]  # EXPECT
d = os.environ.setdefault("DL4J_CUDA_ETL_WORKERS", "0")  # EXPECT
on = env_str("DL4J_CUDA_ZIP_STORED") == "1"  # EXPECT
off = env_str("DL4J_CUDA_FIT_PREFETCH") != "0"  # EXPECT
