"""Process-group initialization: the port's counterpart of
``spec_viterbi_tpu/parallel/distributed.py``.

A launcher calls :func:`init_distributed` once per process before making a
:class:`~spec_viterbi_tpu_torch.parallel.mesh.DistributedGroup`. Nothing
tells a program of its cluster, so the coordinator address, the process
count and this process's id come as arguments or from the variables that
``torchrun`` sets (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``). The backend is NCCL between CUDA devices and gloo on the CPU.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: torch.device | str | None = None,
) -> bool:
    """Initialize the ``torch.distributed`` world; returns True if it spans
    more than one process.

    ``coordinator_address`` is ``host:port`` (TCP rendezvous) or an init
    URL such as ``file:///path``; without it, ``MASTER_ADDR`` and
    ``MASTER_PORT`` are read, and with neither this is a single process
    and nothing is initialized (returns False). ``device`` picks the
    backend: NCCL for a CUDA device, gloo for the CPU; by default NCCL
    where CUDA is available. Safe to call again: an initialized world
    returns its answer unchanged.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (
            f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
        )
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if not coordinator_address:
        return False  # single process
    if num_processes is None or process_id is None:
        raise ValueError("a process group needs num_processes and process_id (or WORLD_SIZE and RANK)")
    if device is None:
        cuda = torch.cuda.is_available()
    else:
        cuda = torch.device(device).type == "cuda"
    init_method = (
        coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    )
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=init_method,
        world_size=num_processes,
        rank=process_id,
    )
    return num_processes > 1


def process_info() -> dict:
    """{'process_id', 'process_count', 'local_devices', 'global_devices'}.

    ``local_devices`` counts the CUDA devices this process sees (1 on the
    CPU); ``global_devices`` the devices of the world, one per rank (the
    local count for a single process).
    """
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if dist.is_available() and dist.is_initialized():
        count = dist.get_world_size()
        return {
            "process_id": dist.get_rank(),
            "process_count": count,
            "local_devices": local,
            "global_devices": count,
        }
    return {"process_id": 0, "process_count": 1, "local_devices": local, "global_devices": local}
