"""Distributed training and scoring over a (dp, mp) mesh (counterpart of
``topk_rec_tpu/parallel/train_step.py``).

The tables are row-sharded over "mp": each rank holds its block of rows of
the user table, of the item table (and, for VBPR, of the item features)
and of their RMSProp accumulators; VBPR's dense ``cem``/``icb`` are
replicated. JAX compiles the single-device chunk under GSPMD and lets XLA
place the collectives; here every collective is written out:

* every rank draws the same chunk of triplets from the same generator
  (``BPR.sample_chunk``: the sampler and its membership store are
  replicated) and takes its slice of each step's batch;
* the rows a step needs come through the explicit exchange
  (``lookup.py``), the gradients are taken on them with autograd, and the
  owner-side RMSProp applies one update per touched row on the sum of its
  gradients;
* the loss, and VBPR's dense gradients, are summed over the ranks that
  split the batch with ``all_reduce``.

``exchange="gspmd"`` splits each batch over all dp x mp ranks with a
capacity equal to the local batch, which cannot overflow, so it computes
what the single-device ``run_chunk`` computes on the same triplets up to
the order of the sums. The dp replicas of a shard gather what each other
received before they apply it, and so stay bitwise equal.
``exchange="explicit"`` is JAX's parameter-server mode on a pure-mp mesh,
with JAX's capacities: an overflowed lookup voids its triplet (weight 0)
and the dropped uniques are counted in ``last_overflow``.
"""

from __future__ import annotations

import socket
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..models.bpr import (
    BPRTables,
    INIT_STREAM,
    _pairwise_loss,
    stream_generator,
)
from ..models.vbpr import VBPRTables, _rms_dense, _vbpr_loss
from ..ops.topk_fused import topk_stable
from .distributed import all_gather_rows
from .lookup import _exchange, _exchange_rmsprop, _Route
from .mesh import BPR_PARAM_SPECS, VBPR_PARAM_SPECS, Mesh, shard_params, \
    shard_rows


def spans_hosts(mesh: Mesh) -> bool:
    """True when the mesh's ranks run on more than one host."""
    names = [None] * mesh.size
    dist.all_gather_object(names, socket.gethostname(), group=mesh.group)
    return len(set(names)) > 1


class _DistributedPairwiseTrainer:
    """Shared machinery: shard the model's state, run chunks, gather it
    back."""

    PARAM_SPECS: Dict[str, Optional[str]] = {}

    def __init__(self, model, mesh: Mesh, batch_size: int = 4096,
                 scan_steps: int = 8):
        if model.inter is None:
            raise ValueError("load data before distributing")
        if model.device != mesh.device:
            raise ValueError(f"the model lives on {model.device}, this "
                             f"rank's mesh device is {mesh.device}")
        mp = mesh.shape["mp"]
        n_users, n_items = model.inter.n_users, model.inter.n_items
        if n_users % mp or n_items % mp:
            raise ValueError(
                f"user/item counts ({n_users}/{n_items}) must divide the "
                f"model axis ({mp}): pad the tables or pick a different "
                "mesh")
        if batch_size % mesh.size:
            raise ValueError(f"batch {batch_size} does not divide the "
                             f"{mesh.size} ranks")
        self.model = model
        self.mesh = mesh
        self.batch_size = batch_size
        self.scan_steps = scan_steps
        self.b_local = batch_size // mesh.size
        self.rows_u = n_users // mp
        self.rows_i = n_items // mp
        if model.tables is None:
            model._init_params(stream_generator(model.seed, INIT_STREAM,
                                                model.device))
        self.tables = self._make_tables(
            shard_params(mesh, model.tables.params(), self.PARAM_SPECS))
        self.tables.load(ms=shard_params(mesh, model.tables.ms(),
                                         self.PARAM_SPECS))

    def _make_tables(self, params):
        raise NotImplementedError

    def _step(self, u, i, j) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step on this rank's triplets: (its loss, its dropped
        uniques as int32 [1])."""
        raise NotImplementedError

    def load(self, params, ms=None) -> None:
        """Load full tables (numpy or tensors, the model's ``params()`` /
        ``ms()`` keys) into this rank's shards."""
        self.tables.load(shard_params(self.mesh, params, self.PARAM_SPECS),
                         None if ms is None else
                         shard_params(self.mesh, ms, self.PARAM_SPECS))

    def _gather(self, tree) -> Dict[str, torch.Tensor]:
        return {name: (t.clone() if self.PARAM_SPECS[name] is None else
                       all_gather_rows(t, self.mesh.groups[
                           self.PARAM_SPECS[name]]))
                for name, t in tree.items()}

    def state(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(params, ms): the full tables and accumulators, gathered onto
        every rank."""
        return self._gather(self.tables.params()), \
            self._gather(self.tables.ms())

    def sample_chunk(self, gen: torch.Generator):
        """The full chunk (u, i, j), each [scan_steps, batch_size]: every
        rank draws the same one from the same generator state."""
        return self.model.sample_chunk(gen, self.scan_steps, self.batch_size)

    def run_chunk(self, u, i, j) -> float:
        """Run the steps of a full chunk (as :meth:`sample_chunk` gives it)
        on this rank's slice of each batch; returns the chunk's loss summed
        over all ranks."""
        at = self.mesh.rank * self.b_local
        u, i, j = (t[:, at:at + self.b_local].to(self.mesh.device)
                   for t in (u, i, j))
        losses, ovf = [], torch.zeros(1, dtype=torch.int32,
                                      device=self.mesh.device)
        for s in range(u.shape[0]):
            loss, o = self._step(u[s], i[s], j[s])
            losses.append(loss)
            ovf += o
        total = torch.stack(losses).sum()
        dist.all_reduce(total, group=self.mesh.group)
        self._overflow = ovf
        return float(total)

    def train_chunk(self, gen: torch.Generator) -> float:
        return self.run_chunk(*self.sample_chunk(gen))

    def sync_to_model(self) -> None:
        """Gather the sharded tables back into the model (every rank ends
        holding the full tables) and refresh its host arrays."""
        params, ms = self.state()
        self.model.tables = self._make_tables(params)
        self.model.tables.load(ms=ms)
        self.model._sync_host()


class DistributedBPRTrainer(_DistributedPairwiseTrainer):
    """BPR with the tables row-sharded over "mp" (train_step.py:129-358).

    * ``exchange="gspmd"`` (default): each batch split over all ranks; the
      same numerics as the single-device chunk, on any dp x mp mesh.
    * ``exchange="explicit"``: a pure-mp mesh, JAX's capacities
      (``capacity`` or ``max(8, 2·ceil(b_local / S))`` for the user rows,
      twice that for [i ‖ j]); triplets whose rows overflowed are voided
      and the dropped uniques summed over the ranks in ``last_overflow``.
    * ``exchange="auto"``: explicit when the mesh is pure-mp and its ranks
      span more than one host (JAX asks for more than one process, but
      here every rank is a process; the hosts are what a slow link
      separates), gspmd otherwise.
    """

    PARAM_SPECS = BPR_PARAM_SPECS

    def __init__(self, model, mesh: Mesh, batch_size: int = 4096,
                 scan_steps: int = 8, exchange: str = "gspmd",
                 capacity: int = 0):
        if exchange not in ("gspmd", "explicit", "auto"):
            raise ValueError(f"exchange must be gspmd|explicit|auto, got "
                             f"{exchange!r}")
        pure_mp = mesh.shape["dp"] == 1
        if exchange == "auto":
            exchange = ("explicit" if pure_mp and spans_hosts(mesh)
                        else "gspmd")
        if exchange == "explicit" and not pure_mp:
            raise ValueError("explicit exchange shards the batch over 'mp'; "
                             "use a pure-mp mesh (dp=1)")
        self.exchange = exchange
        self.capacity = capacity
        self.last_overflow = 0
        super().__init__(model, mesh, batch_size, scan_steps)
        s = mesh.shape["mp"]
        self.cap_u = capacity or max(8, 2 * (-(-self.b_local // s)))

    def _make_tables(self, params):
        return BPRTables(params["ue"], params["ie"], params["ib"])

    def _step(self, u, i, j):
        t, m, mesh = self.tables, self.model, self.mesh
        bl = u.shape[0]
        ij = torch.cat([i, j])
        if self.exchange == "explicit":
            cap, cap_ij = self.cap_u, 2 * self.cap_u
            pu, vu, o1 = _exchange(t.ue, u, mesh, "mp", self.rows_u, cap,
                                   with_valid=True)
            pit, vi, o2 = _exchange(t.iet, i, mesh, "mp", self.rows_i, cap,
                                    with_valid=True)
            pjt, vj, o3 = _exchange(t.iet, j, mesh, "mp", self.rows_i, cap,
                                    with_valid=True)
            # a triplet with a zero stand-in row is voided whole
            # (train_step.py:237-252)
            w = (vu & vi & vj).float()
            pij = torch.cat([pit, pjt])
            ovf = o1 + o2 + o3
        else:
            cap, cap_ij = bl, 2 * bl
            pu, o1 = _exchange(t.ue, u, mesh, "mp", self.rows_u, cap)
            pij, o2 = _exchange(t.iet, ij, mesh, "mp", self.rows_i, cap_ij)
            w = None
            ovf = o1 + o2
        with torch.enable_grad():
            pu.requires_grad_()
            pij.requires_grad_()
            loss = _pairwise_loss(pu, pij[:bl], pij[bl:], m.lu, m.li, m.lj,
                                  m.lb, m.mode, t.k, w)
            gu, gij = torch.autograd.grad(loss, (pu, pij))
        _, _, o4 = _exchange_rmsprop(t.ue, t.ms_u, u, gu, mesh, "mp",
                                     self.rows_u, cap, m.lr, replicas="dp")
        _, _, o5 = _exchange_rmsprop(t.iet, t.ms_it, ij, gij, mesh, "mp",
                                     self.rows_i, cap_ij, m.lr,
                                     replicas="dp")
        return loss.detach(), ovf + o4 + o5

    def run_chunk(self, u, i, j) -> float:
        loss = super().run_chunk(u, i, j)
        if self.exchange == "explicit":
            dist.all_reduce(self._overflow, group=self.mesh.groups["mp"])
            self.last_overflow = int(self._overflow)
        return loss


class DistributedVBPRTrainer(_DistributedPairwiseTrainer):
    """VBPR (train_step.py:361-419): the rating tables and the item
    features row-sharded over "mp", ``cem`` and ``icb`` replicated. Each
    batch is split over all ranks; the dense gradients are summed over them
    with ``all_reduce`` before the dense RMSProp, and their regularization
    is counted once (on rank 0), so the sum is the full batch's gradient."""

    PARAM_SPECS = VBPR_PARAM_SPECS

    def __init__(self, model, mesh: Mesh, batch_size: int = 4096,
                 scan_steps: int = 8):
        if model.feat is None:
            raise ValueError("set features before distributing")
        super().__init__(model, mesh, batch_size, scan_steps)
        self.feat = shard_rows(mesh, model.feat, "mp")

    def _make_tables(self, params):
        return VBPRTables(params)

    def _step(self, u, i, j):
        t, m, mesh = self.tables, self.model, self.mesh
        bl = u.shape[0]
        ij = torch.cat([i, j])
        put, o1 = _exchange(t.ut, u, mesh, "mp", self.rows_u, bl)
        # the item rows and their features share one route
        route = _Route(ij, mesh, "mp", self.rows_i, 2 * bl)
        pij = route.gather(t.it)
        fij = route.gather(self.feat)
        with torch.enable_grad():
            put.requires_grad_()
            pij.requires_grad_()
            cem = t.cem.detach().requires_grad_()
            icb = t.icb.detach().requires_grad_()
            loss = _vbpr_loss(put, pij[:bl], pij[bl:], cem, icb, fij[:bl],
                              fij[bl:], m.hyper(), m.mode, t.kh,
                              dense_reg=mesh.rank == 0)
            gu, gij, g_cem, g_icb = torch.autograd.grad(
                loss, (put, pij, cem, icb))
        dist.all_reduce(g_cem, group=mesh.group)
        dist.all_reduce(g_icb, group=mesh.group)
        _exchange_rmsprop(t.ut, t.ms_ut, u, gu, mesh, "mp", self.rows_u, bl,
                          m.lr, replicas="dp")
        _exchange_rmsprop(t.it, t.ms_it, ij, gij, mesh, "mp", self.rows_i,
                          2 * bl, m.lr, replicas="dp")
        _rms_dense(t.cem, t.ms_cem, g_cem, m.lr)
        _rms_dense(t.icb, t.ms_icb, g_icb, m.lr)
        return loss.detach(), o1 + route.overflow.reshape(1).int()


def _padded(t: torch.Tensor, n: int, value: float) -> torch.Tensor:
    """``t`` with its rows padded to a multiple of ``n`` with ``value``."""
    pad = (-t.shape[0]) % n
    if not pad:
        return t
    return torch.cat([t, t.new_full((pad, *t.shape[1:]), value)])


def distributed_scores_topk(mesh: Mesh, U, V, bias, k: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Full-catalog scores and top-k over a 2-D split (train_step.py:422-
    460): rank (d, m) computes the [users/dp, items/mp] tile of U·Vᵀ + b
    with ``torch.matmul`` (true fp32), the tiles are gathered along "mp",
    each row's top-k is taken in ``lax.top_k`` order, and the rows are
    gathered along "dp". Every rank returns the full (values [n_u, k],
    item ids [n_u, k]) as numpy. U is padded with zero rows to a multiple
    of dp and V to a multiple of mp, the padded items scoring -inf."""
    def tensor(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32))

    U, V = tensor(U), tensor(V)
    n_u, n_i = U.shape[0], V.shape[0]
    b = torch.zeros(n_i) if bias is None else tensor(bias).reshape(-1)
    u_loc = shard_rows(mesh, _padded(U, mesh.shape["dp"], 0.0), "dp")
    v_loc = shard_rows(mesh, _padded(V, mesh.shape["mp"], 0.0), "mp")
    b_loc = shard_rows(mesh, _padded(b, mesh.shape["mp"], -np.inf), "mp")
    tile = u_loc @ v_loc.T + b_loc[None, :]
    # gather the tiles' columns: rows of the transposes
    scores = all_gather_rows(tile.T, mesh.groups["mp"]).T[:, :n_i]
    vals, idx = topk_stable(scores, k)
    vals = all_gather_rows(vals, mesh.groups["dp"])[:n_u]
    idx = all_gather_rows(idx.int(), mesh.groups["dp"])[:n_u]
    return vals.cpu().numpy(), idx.cpu().numpy()
