"""Multi-process execution (counterpart of
``topk_rec_tpu/parallel/distributed.py``).

Every rank is one process with one device. :func:`initialize` joins this
process to the run through ``torch.distributed.init_process_group`` (the
counterpart of ``jax.distributed.initialize``) before any collective;
:func:`fetch` reads a row-sharded tensor back whole on every rank. The
small collective helpers the mesh code shares live here too: each pads
nothing, so the callers give them equal-sized pieces.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import backend_for, local_rank


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Join this process to a multi-process run (distributed.py:29-57).

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or a URL
    that ``init_process_group`` takes (``tcp://host:port``,
    ``file:///path``); each argument falls back to ``TKR_COORDINATOR`` /
    ``TKR_NUM_PROCESSES`` / ``TKR_PROCESS_ID``. The backend follows
    ``device``: NCCL for ``cuda`` (this process takes the card of its
    local rank), gloo for ``cpu``. A failed rendezvous raises.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "TKR_COORDINATOR")
    if num_processes is None and "TKR_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["TKR_NUM_PROCESSES"])
    if process_id is None and "TKR_PROCESS_ID" in os.environ:
        process_id = int(os.environ["TKR_PROCESS_ID"])
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize needs the coordinator address, the number of "
            "processes and this process's id (arguments or TKR_COORDINATOR "
            "/ TKR_NUM_PROCESSES / TKR_PROCESS_ID)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank(process_id))
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend_for(dev), init_method=init_method,
                            world_size=num_processes, rank=process_id)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) stacked along dim 0, in group-rank
    order, on every rank of ``group``."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather(list(out.chunk(n)), t, group=group)
    return out


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """Block s of dim 0 goes to group rank s; block s of the result came
    from group rank s (``lax.all_to_all`` with split = concat = 0)."""
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


def fetch(t, mesh=None, axis: Optional[str] = "mp") -> np.ndarray:
    """A tensor back in host memory as numpy (distributed.py:64-78).

    numpy arrays pass through. With a ``mesh``, ``t`` is this rank's block
    of rows of a table row-sharded over ``axis``: the blocks are gathered
    first, so every rank holds the full value. Without one (or with
    ``axis=None``), ``t`` is copied as it is.
    """
    if isinstance(t, np.ndarray):
        return t
    if mesh is not None and axis is not None:
        t = all_gather_rows(t, mesh.groups[axis])
    return t.detach().cpu().numpy()
