"""Start the process group of a multi-process run (``tpuhar/parallel/distributed.py``).

One call makes every process a member of one ``torch.distributed`` group, over which
``parallel.mesh`` builds the data-parallel mesh. The arguments default to torchrun's
environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``);
in a single process the call does nothing, so the same entry point runs everywhere.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# the longest wait at a collective: the other ranks wait while rank 0 alone runs a stage
# that takes no mesh (cli: few-shot, leave-one-out), which takes minutes
TIMEOUT = datetime.timedelta(hours=2)


def initialize_distributed(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, *, device="cuda",
                           backend: Optional[str] = None) -> bool:
    """Join the process group; returns True when more than one process takes part.

    ``coordinator_address`` is ``"host:port"`` of rank 0 (default ``MASTER_ADDR:
    MASTER_PORT``), ``num_processes`` the world size (``WORLD_SIZE``), ``process_id``
    this rank (``RANK``). Returns False, and starts nothing, where the world is one
    process or none is given. The backend is NCCL for ``"cuda"`` (each process on the
    card of its ``LOCAL_RANK``, else of its rank modulo the cards there are) and gloo for
    ``"cpu"``; ``backend="gloo"`` on ``"cuda"`` lets several processes share a card,
    which NCCL refuses. A group that is already up is kept."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None or num_processes is None or num_processes <= 1:
        return False
    if process_id is None:
        raise ValueError("a multi-process run needs this process's rank (process_id or RANK)")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        local = int(env.get("LOCAL_RANK", process_id % max(torch.cuda.device_count(), 1)))
        torch.cuda.set_device(local)
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"), init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=TIMEOUT)
    return True


def local_batch_slice(global_batch: int) -> slice:
    """This process's rows of a global batch split evenly over the processes (all of
    them in one process)."""
    if not (dist.is_available() and dist.is_initialized()):
        return slice(0, global_batch)
    per = global_batch // dist.get_world_size()
    return slice(dist.get_rank() * per, (dist.get_rank() + 1) * per)
