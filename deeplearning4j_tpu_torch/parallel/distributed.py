"""Multi-process runtime: one process per rank in a `torch.distributed`
process group.

Counterpart of the JAX package's `parallel/distributed.py` (the
reference's Spark driver/executor and Aeron `VoidParameterServer` control
planes). The reference joins a JAX cluster and drives every local device
from one process; the port runs one process per rank. `initialize_distributed`
forms the group: NCCL for CUDA ranks, gloo on the CPU (or where the
config asks for it, as two ranks sharing one card must: NCCL will not put
two ranks on one GPU). Rank r's device is ``cuda:LOCAL_RANK``.

The group's address comes from the reference's variables
(``COORDINATOR_ADDRESS`` "host:port", ``NUM_PROCESSES``, ``PROCESS_ID``)
or from torchrun's (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``). A failed init raises: the reference's
"continuing single-process" warning would hide a misconfigured group.
Only the coordinator (rank 0) writes checkpoints; every rank restores
(`train/resilience.py`).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class DistributedConfig:
    """The analog of DL4J's VoidConfiguration, reduced to what a process
    group needs. `backend` None picks NCCL for CUDA and gloo for the
    CPU."""
    coordinator_address: Optional[str] = None   # "host:port" of rank 0
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_rank: Optional[int] = None
    backend: Optional[str] = None
    initialization_timeout_s: int = 300

    @staticmethod
    def from_env() -> "DistributedConfig":
        """The reference's variables, else torchrun's."""
        env = os.environ
        cfg = DistributedConfig()
        if "COORDINATOR_ADDRESS" in env:
            cfg.coordinator_address = env["COORDINATOR_ADDRESS"]
        elif "MASTER_ADDR" in env and "MASTER_PORT" in env:
            cfg.coordinator_address = \
                f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        for attr, names in (("num_processes", ("NUM_PROCESSES",
                                               "WORLD_SIZE")),
                            ("process_id", ("PROCESS_ID", "RANK"))):
            for name in names:
                if name in env:
                    setattr(cfg, attr, int(env[name]))
                    break
        if "LOCAL_RANK" in env:
            cfg.local_rank = int(env["LOCAL_RANK"])
        return cfg

    @property
    def configured(self) -> bool:
        return self.coordinator_address is not None


def free_port() -> int:
    """A free TCP port on localhost (for a group of this host's ranks)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device_type: str, config: Optional[DistributedConfig] = None
                ) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` (LOCAL_RANK defaults
    to 0) for CUDA, the CPU otherwise."""
    if device_type != "cuda":
        return torch.device(device_type)
    cfg = config or DistributedConfig.from_env()
    return torch.device("cuda", cfg.local_rank or 0)


def initialize_distributed(config: Optional[DistributedConfig] = None,
                           device_type: str = "cuda",
                           single: bool = False) -> bool:
    """Join (or form) the process group. Idempotent. Returns True when
    more than one rank is in the group after the call.

    With no address in `config` (default: `from_env()`), nothing is
    formed unless `single`, which forms a one-rank group on a free local
    port (the train CLI launched alone). Any failure to form the group
    raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    config = config or DistributedConfig.from_env()
    if not config.configured:
        if not single:
            return False
        config = dataclasses.replace(
            config, coordinator_address=f"127.0.0.1:{free_port()}",
            num_processes=1, process_id=0)
    if config.num_processes is None or config.process_id is None:
        raise RuntimeError(
            f"process group at {config.coordinator_address} needs the world "
            "size and this process's rank (NUM_PROCESSES/PROCESS_ID or "
            "WORLD_SIZE/RANK)")
    backend = config.backend or ("nccl" if device_type == "cuda"
                                 else "gloo")
    if device_type == "cuda" and backend == "nccl":
        torch.cuda.set_device(rank_device("cuda", config))
    dist.init_process_group(
        backend, init_method=f"tcp://{config.coordinator_address}",
        world_size=int(config.num_processes), rank=int(config.process_id),
        timeout=datetime.timedelta(seconds=config.initialization_timeout_s))
    return dist.get_world_size() > 1


def shutdown_distributed():
    """Leave the process group, if one is formed."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on the TrainingMaster-role process (rank 0)."""
    return process_index() == 0

