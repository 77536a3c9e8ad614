"""Rank meshes and sharding helpers (counterpart of
``topk_rec_tpu/parallel/mesh.py``).

JAX builds a ``jax.sharding.Mesh`` of devices and lets XLA insert the
collectives. PyTorch has no GSPMD, so here a :class:`Mesh` is the grid of
``torch.distributed`` ranks, one device per rank, and every collective is
written by hand against the process groups it holds:

* axis "dp" (data parallel): batches are split across it;
* axis "mp" (model parallel): the user and item tables are row-sharded
  across it.

Rank ``r`` sits at (dp, mp) = (r // mp, r % mp), the order of JAX's
``np.asarray(devices).reshape(dp, mp)``. The ranks that share a dp index
form an mp group, and those that share an mp index a dp group.

The collectives run on NCCL when the mesh's device is a card and on gloo
when the caller asks for the CPU; the backend follows the device asked
for, and a mismatch raises instead of falling back.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

AXES = ("dp", "mp")


def backend_for(device: torch.device) -> str:
    """The collective backend of a device type: NCCL on a card, gloo on the
    CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def local_rank(rank: int) -> int:
    """The card index of ``rank`` on its host: ``LOCAL_RANK`` when the
    launcher sets it, else the rank modulo the host's card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(1, torch.cuda.device_count())


def rank_device(device) -> torch.device:
    """The device of this rank for a mesh on ``device``: ``cuda:<local
    rank>`` (made current with ``torch.cuda.set_device``) or ``cpu``.
    Raises when the process group's backend is not the device's."""
    dev = resolve_device(device)
    backend = dist.get_backend()
    if backend != backend_for(dev):
        raise RuntimeError(
            f"a mesh on {dev.type} needs the {backend_for(dev)} backend; "
            f"the process group runs {backend}")
    if dev.type == "cuda":
        index = local_rank(dist.get_rank())
        torch.cuda.set_device(index)
        dev = resolve_device(f"cuda:{index}")
    return dev


class Mesh:
    """A (dp, mp) grid over every rank of the process group.

    Attributes: ``shape`` ({"dp": dp, "mp": mp}), ``coords`` (this rank's
    index on each axis), ``rank`` and ``size`` (global), ``device``,
    ``groups`` (this rank's process group along each axis) and ``group``
    (all ranks).
    """

    axis_names = AXES

    def __init__(self, dp: int, mp: int, device: torch.device):
        world = dist.get_world_size()
        if dp * mp != world:
            raise ValueError(
                f"mesh {dp}x{mp} needs {dp * mp} ranks; the process group "
                f"has {world}")
        self.shape = {"dp": dp, "mp": mp}
        self.rank = dist.get_rank()
        self.size = world
        self.coords = {"dp": self.rank // mp, "mp": self.rank % mp}
        self.device = device
        self.group = dist.group.WORLD
        # every rank creates every group, in the same order
        self.groups = {}
        for d in range(dp):
            g = dist.new_group([d * mp + m for m in range(mp)])
            if d == self.coords["dp"]:
                self.groups["mp"] = g
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)])
            if m == self.coords["mp"]:
                self.groups["dp"] = g

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, mp={self.shape['mp']}, "
                f"rank={self.rank}, device={self.device})")


def _largest_pow2_leq(x: int) -> int:
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


def make_mesh(
    n_devices: Optional[int] = None,
    dp: Optional[int] = None,
    mp: Optional[int] = None,
    device="cuda",
) -> Mesh:
    """Build a (dp, mp) mesh over every rank (mesh.py:25-48).

    With only ``n_devices`` (default: the world size) given, the split is
    roughly square, dp x mp with dp >= mp, as in JAX. Without a process
    group, a one-rank group is made for this process (NCCL for a card,
    gloo for the CPU), so a 1 x 1 mesh needs no launcher; the caller ends
    it with ``torch.distributed.destroy_process_group()`` (an NCCL group
    left to the interpreter's exit can hold the process there for minutes).
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n != world:
        raise ValueError(
            f"a mesh spans every rank: {n} devices asked for, the process "
            f"group has {world}")
    if dp is None or mp is None:
        mp = mp or _largest_pow2_leq(int(np.sqrt(n)))
        while n % mp:
            mp //= 2
        dp = n // mp
    if dp * mp != world:
        raise ValueError(f"mesh {dp}x{mp} needs {dp * mp} ranks; the "
                         f"process group has {world}")
    if not dist.is_initialized():
        dist.init_process_group(backend_for(resolve_device(device)),
                                store=dist.HashStore(), rank=0, world_size=1)
    return Mesh(dp, mp, rank_device(device))


def _tensor(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    arr = np.asarray(arr)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def shard_rows(mesh: Mesh, arr, axis: Optional[str]) -> torch.Tensor:
    """This rank's copy of ``arr`` on the mesh's device: its block of rows
    along ``axis`` (the rows must divide the axis size), or the whole array
    when ``axis`` is None (replicated)."""
    t = _tensor(arr)
    if axis is not None:
        n = mesh.shape[axis]
        if t.shape[0] % n:
            raise ValueError(
                f"{t.shape[0]} rows do not divide the {axis} axis ({n}): "
                "pad the table or pick another mesh")
        per = t.shape[0] // n
        at = mesh.coords[axis] * per
        t = t[at:at + per]
    return t.to(mesh.device).clone()


def shard_params(mesh: Mesh, params: Dict, specs: Dict) -> Dict:
    """This rank's shards of a dictionary of arrays; ``specs[name]`` is the
    axis its rows are sharded over, or None for a replicated one."""
    return {name: shard_rows(mesh, arr, specs[name])
            for name, arr in params.items()}


def replicate(mesh: Mesh, tree):
    """Copies of an array, or of a dict / list / tuple of arrays, on the
    mesh's device."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    return shard_rows(mesh, tree, None)


# The canonical shardings (mesh.py:67-88): embedding tables row-sharded over
# "mp", the dense content projection and bias replicated.
BPR_PARAM_SPECS = {"ue": "mp", "ie": "mp", "ib": "mp"}

VBPR_PARAM_SPECS = {
    "ure": "mp", "uce": "mp", "ire": "mp", "irb": "mp",
    "cem": None, "icb": None,
}
