"""Multi-process initialisation and the host-local batch helpers.

Counterpart of `llm_qat_tpu/parallel/multihost.py`. JAX needs
`jax.distributed.initialize` before a multi-host run; the port needs the
default `torch.distributed` process group, after which the mesh helpers of
`parallel.mesh` run unchanged on one process or many. The port runs one
process per device, so a process's "local devices" are one device and the
global device count is the world size.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..device import resolve_device


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         device=None) -> dict:
    """Initialise the default process group (a no-op for one process).

    Arguments default to torch's variables: MASTER_ADDR and MASTER_PORT
    (the coordinator, "host:port"), WORLD_SIZE and RANK. A coordinator
    given as a URL ("file:///path", "tcp://host:port") is used as the
    init method as it is. The backend is NCCL on the card (the default
    device, which raises without one) and gloo for `device="cpu"`.

    Returns process_index, process_count, local_devices and global_devices,
    as JAX's does; one device per process, so local_devices is 1 and
    global_devices is the world size.
    """
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])

    if not dist.is_initialized() and num_processes and num_processes > 1:
        dev = resolve_device(device)
        url = coordinator_address or ""
        if "://" not in url:
            url = f"tcp://{url}"
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=url, world_size=num_processes,
                                rank=process_id or 0)
    count = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": count,
        "local_devices": 1,
        "global_devices": count,
    }


def _process():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_local_batch_slice(global_batch: int) -> slice:
    """Rows of the global batch owned by this process (DP over processes)."""
    i, n = _process()
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def make_global_batch(local_array, mesh, placements) -> DTensor:
    """A DTensor spanning the processes from each process's own rows
    (`host_local_batch_slice`): `DTensor.from_local` with `placements`
    (e.g. `batch_sharding(mesh)`)."""
    if not isinstance(local_array, torch.Tensor):
        local_array = torch.from_numpy(np.asarray(local_array))
    local = local_array.to(mesh.device_type)
    return DTensor.from_local(local, mesh, placements, run_check=False)
