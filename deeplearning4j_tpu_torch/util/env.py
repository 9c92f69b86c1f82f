"""Typed accessors for every ``DL4J_CUDA_*`` environment knob.

A copy of the JAX package's `util/env.py` contract, for the port's own
knobs:

- **Kill switches** (features on by default): ONLY the literal ``"0"``
  disables. Unset, ``""``, ``"false"``, ``"2"`` leave the feature ON.
- **Opt-ins** (features off by default): ONLY the literal ``"1"`` enables.
- **Values**: ``""`` is UNSET, never a value.

The port's knobs, each read where it acts:

- ``DL4J_CUDA_FLASH_BLOCK_Q`` / ``_K`` (value): flash padding blocks
  (`ops/flash_attention.py`);
- ``DL4J_CUDA_SCAN_STEPS`` (value, default 1): fit's scan_steps
  (`nn/step_graph.default_scan_steps`), the counterpart of
  ``DL4J_TPU_SCAN_STEPS``;
- ``DL4J_CUDA_FIT_PREFETCH`` (kill switch) and ``DL4J_CUDA_PREFETCH_DEPTH``
  (value, default 2; ``0`` disables the thread): fit's prefetch
  (`data/async_iterator.py`);
- ``DL4J_CUDA_DATA_DIR`` (value, default the reference's
  ``~/.deeplearning4j_tpu/datasets``): the fetchers' dataset cache
  (`data/fetchers.data_dir`), the counterpart of ``DL4J_TPU_DATA_DIR``.
- ``DL4J_CUDA_ETL_WORKERS`` (value, default ``auto``; ``0`` runs the
  loader in-process), ``DL4J_CUDA_ETL_MIN_RECORDS`` (value, default
  512), ``DL4J_CUDA_ETL_RING_SLOTS`` (value, default workers + 2) and
  ``DL4J_CUDA_ETL_MP_START`` (value, default ``spawn``): the
  multi-process ring (`data/pipeline.py`);
- ``DL4J_CUDA_CSV_FAST_MAX_BYTES`` (value, default 1 GiB): the CSV
  reader's matrix path (`data/records.py`);
- ``DL4J_CUDA_PEAK_FLOPS`` and ``DL4J_CUDA_HBM_BYTES_PER_SEC`` (values):
  the MFU accountant's device peaks (`monitor/xla.py`);
  ``DL4J_CUDA_PERF_LEDGER`` (value): the train CLI's default
  `--perf-ledger` path (`train/cli.py`);
- ``DL4J_CUDA_ZIP_STORED`` (opt-in): `save_model` stores the entries of
  the zips it writes instead of deflating them
  (`util/serialization.py`): float weights deflate by a few percent at
  tens of MB/s on the host;
- ``DL4J_CUDA_FAULTS`` and ``DL4J_CUDA_SERVING_FAULTS`` (values): the
  fault schedules (`util/faults.py`);
- ``DL4J_CUDA_LOCK_DIAG`` (opt-in): lock-order recording
  (`util/locks.py`); ``DL4J_CUDA_DEADLOCK_SENTINEL`` (kill switch) and
  ``DL4J_CUDA_SENTINEL_TIMEOUT`` (value, default 300 s): the pytest
  deadlock sentinel (`util/sentinel.py`).

Each replaces the reference's ``DL4J_TPU_*`` name, but
``DL4J_CUDA_ZIP_STORED``, the port's own.
"""
from __future__ import annotations

import os
from typing import Optional


def env_raw(name: str) -> Optional[str]:
    """The raw value with ``""`` normalized to unset (None)."""
    v = os.environ.get(name)
    if v is None or v == "":
        return None
    return v


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """String knob; ``""`` means unset and yields `default`."""
    v = env_raw(name)
    return default if v is None else v


def env_int(name: str, default: Optional[int] = None) -> Optional[int]:
    """Integer knob; unset/``""`` yields `default`. A non-integer value
    raises ValueError naming the variable."""
    v = env_raw(name)
    if v is None:
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected an integer") from None


def env_float(name: str, default: Optional[float] = None) -> Optional[float]:
    """Float knob; unset/``""`` yields `default`."""
    v = env_raw(name)
    if v is None:
        return default
    try:
        return float(v)
    except ValueError:
        raise ValueError(f"{name}={v!r}: expected a number") from None


def env_flag(name: str, default: bool = True) -> bool:
    """`default=True` (kill switch): ONLY ``"0"`` disables.
    `default=False` (opt-in): ONLY ``"1"`` enables."""
    v = env_raw(name)
    if v is None:
        return default
    if default:
        return v != "0"
    return v == "1"

