"""What the examples share: the device they run on, their command line,
the process group of the parallel ones, and the digits dataset."""
from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

from deeplearning4j_tpu_torch.util.platform import (
    resolve_device, set_f32_matmul_exact,
)


def device_of(device=None) -> torch.device:
    """The example's device: CUDA unless the caller asks for another,
    raising when CUDA is asked for and missing; float32 products stay in
    float32 (TF32 off), as at every entry point of the port."""
    dev = resolve_device(device)
    set_f32_matmul_exact()
    return dev


def load_digits():
    """The 1,797 8x8 handwritten digits (UCI "Optical Recognition of
    Handwritten Digits", CC BY 4.0) as scikit-learn bundles them, stored
    beside the examples (`digits.npz`, 45 KB) so the examples that read
    them need no scikit-learn: (images (1797, 8, 8) float64 in 0..16,
    target (1797,) int64), sklearn's `load_digits()` values."""
    with np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "digits.npz")) as z:
        return z["images"].astype(np.float64), z["target"].astype(np.int64)


def host(a) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@contextlib.contextmanager
def process_group(device: torch.device):
    """The group a parallel example trains in: the caller's when one is
    formed (ranks started by a launcher join theirs through the
    environment: COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID or
    torchrun's variables), else a one-rank group formed here and left on
    the way out."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel.distributed import (
        initialize_distributed, shutdown_distributed,
    )
    if dist.is_initialized():
        yield
        return
    initialize_distributed(device_type=device.type, single=True)
    try:
        yield
    finally:
        shutdown_distributed()


def cli(main, argv=None, **kwargs):
    """Run `main` from the command line: ``--device`` (default CUDA) is
    the one flag; `kwargs` are the script's own defaults."""
    doc = (sys.modules[main.__module__].__doc__ or "").strip()
    p = argparse.ArgumentParser(description=doc.split("\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda; raises without it)")
    args = p.parse_args(argv)
    return main(device=args.device, **kwargs)
