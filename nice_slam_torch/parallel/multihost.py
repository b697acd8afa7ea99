"""Multi-process launch of the port: one process per rank, joined in a
torch.distributed process group (the counterpart of the JAX package's
nice_slam_tpu/parallel/multihost.py:38-88).

Every rank runs the same deterministic engine loop (same data, same
generator stream), so its state stays bit-identical to the other ranks'
with no pose or keyframe traffic.  The mapping optimisation is the one
computation across ranks (parallel/data_parallel.py): each rank renders
its slice of the union ray batch and one all_reduce per iteration sums the
loss and the live gradients.

The backend is decided from the device layout before the group exists,
never by catching a failure:
- gloo on the CPU, and wherever two ranks share one card (NCCL refuses two
  ranks on one device);
- NCCL where every rank has a card of its own.
The ranks swap their cards' UUIDs through the TCP store that the
rendezvous opens, so every rank reaches the same choice.

Usage (each process, before its engine is built):
    from nice_slam_torch.parallel.multihost import initialize
    initialize("host0:12345", num_processes=2, process_id=i)
or initialize_from_cfg(cfg) with cfg["tpu"]["multihost"] = {coordinator,
num_processes, process_id}, overridden per process by the environment
(NICE_SLAM_TPU_COORDINATOR, _NUM_PROCESSES, _PROCESS_ID), the same keys
and variables as the JAX package's, so one yaml and one launcher serve
both.  A rank's card is cuda:(LOCAL_RANK mod device_count), LOCAL_RANK
defaulting to the rank.
"""

from __future__ import annotations

import os
import socket
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

ENV_COORDINATOR = "NICE_SLAM_TPU_COORDINATOR"
ENV_NUM_PROCESSES = "NICE_SLAM_TPU_NUM_PROCESSES"
ENV_PROCESS_ID = "NICE_SLAM_TPU_PROCESS_ID"


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now, for a local rendezvous."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_world() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """True on the rank that owns the file outputs (checkpoints, meshes,
    ate.json): every rank computes the same state, so one persists it."""
    return rank_world()[0] == 0


def rank_device(device: str, rank: Optional[int] = None) -> torch.device:
    """The device of a rank: cuda:(LOCAL_RANK mod device_count) for
    device 'cuda' without an index; any other device as given."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if rank is None:
        rank = rank_world()[0]
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(store, rank: int, world: int,
                   dev: torch.device) -> str:
    """'nccl' when every rank has a card of its own, else 'gloo'.  Each
    rank posts its device's identity to `store` and reads the others'."""
    if dev.type != "cuda":
        ident = "cpu"
    else:
        ident = str(torch.cuda.get_device_properties(dev).uuid)
    store.set(f"nice_slam_torch/device/{rank}", ident)
    ids = [store.get(f"nice_slam_torch/device/{r}").decode()
           for r in range(world)]
    if "cpu" in ids or len(set(ids)) < world:
        return "gloo"
    return "nccl"


def initialize(coordinator: str, num_processes: int, process_id: int,
               timeout_s: int = 120, device: str = "cuda") -> int:
    """Join the process group at `coordinator` ("host:port"; rank 0 listens
    there) as rank `process_id` of `num_processes`.  Returns the rank."""
    host, port = coordinator.rsplit(":", 1)
    timeout = timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=timeout)
    dev = rank_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = choose_backend(store, process_id, num_processes, dev)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    if process_id == 0:
        print(f"process group: {num_processes} ranks over {backend} "
              f"(rank 0 on {dev})", flush=True)
    return dist.get_rank()


def initialize_from_cfg(cfg: dict, device: str = "cuda") -> Optional[int]:
    """Initialize from cfg["tpu"]["multihost"] with the environment's
    overrides (nice_slam_tpu/parallel/multihost.py:61-79).  Returns the
    rank, or None when no multi-process run is configured."""
    mh = cfg.get("tpu", {}).get("multihost")
    env_coord = os.environ.get(ENV_COORDINATOR)
    if not mh and not env_coord:
        return None
    mh = dict(mh) if isinstance(mh, dict) else {}
    coord = env_coord or mh.get("coordinator", "127.0.0.1:12765")
    n = int(os.environ.get(ENV_NUM_PROCESSES, mh.get("num_processes", 1)))
    pid = int(os.environ.get(ENV_PROCESS_ID, mh.get("process_id", 0)))
    if n <= 1:
        return None
    return initialize(coord, n, pid, device=device)


def backend() -> Optional[str]:
    """The process group's backend, None without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def shutdown() -> None:
    """Leave the process group, when there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
