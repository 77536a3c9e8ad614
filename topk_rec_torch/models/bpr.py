"""BPR: pairwise-ranking matrix factorization (counterpart of
``topk_rec_tpu/models/bpr.py``).

The model scores x_ui = <u_e, i_e> + b_i and minimizes the pairwise
softplus loss with l2 or l1 regularization (reference single/bpr.py:87-99),
with sparse RMSProp (``ops/sparse_update.py``). Defaults mirror reference
bpr.py:20.

A training chunk has two halves, so that tests can hand both packages the
same triplets:

* :meth:`BPR.sample_chunk`: ``n_steps * batch_size`` triplets in one call
  to the device sampler (one host sync, see ``ops/sampling.py``);
* :func:`run_chunk`: the steps on those triplets. It plans the duplicate
  rows of all steps at once, then each step gathers the unique rows of the
  user table and of the item table (the item bias is column ``k`` of that
  table, bpr.py:248-254), takes the gradients of :func:`_pairwise_loss`
  with ``torch.autograd.grad`` on the gathered rows, sums them per row with
  ``index_add_`` and applies RMSProp in place.

:func:`run_chunk_fused` runs the same steps on one [n_users + n_items,
k + 1] table, user rows first with a bias column held at 0 (bpr.py:172-240):
one plan, one gather, one ``index_add_`` and one RMSProp update per step
where the separate tables take two of each. :meth:`BPR.train` picks it as
the JAX package does (bpr.py:515-518): when asked, or under ``auto`` for a
batch of at least :data:`_FUSED_LAYOUT_MIN_BATCH` on at most
:data:`_FUSED_LAYOUT_MAX_ROWS` rows. Both layouts compute the same
arithmetic on disjoint row ranges, and the sampler draws the same triplets
under either.

The BPR step has no Pallas kernel in the JAX package (it is XLA gathers,
segment sums and scatters), so here it is plain PyTorch: a few dozen small
launches per step, whose overhead sets the pace at batch 256.

Random streams: the init draws come from a generator of their own, and each
epoch from a generator derived from (seed, epoch), so a run resumed at an
epoch boundary repeats the uninterrupted run's stream (bpr.py:520-525).
They are not JAX's streams. On the card ``index_add_`` sums duplicates with
atomics, so two runs there may differ in the last bits; on the CPU a run is
reproducible.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..checkpoint import CheckpointManager
from ..ops.sampling import TripletSampler
from ..ops.sparse_update import (
    apply_planned_rmsprop,
    plan_sparse_updates,
    planned_rows,
)
from ..tracing import span
from ..utils import tprint
from .base import Recommender

INIT_STREAM = 2**31 - 1  # the init's stream, apart from every epoch's


def stream_generator(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from (seed, stream)."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def _pairwise_loss(pu, pit, pjt, lu, li, lj, lb, mode, k, weight=None):
    """BPR batch loss over gathered rows (bpr.py:35-67): the softplus
    pairwise term plus l2/l1 regularization; ``pit``/``pjt`` carry the item
    bias as column ``k``. A zero in the optional per-example ``weight``
    removes that example's whole contribution."""
    pi, bi = pit[:, :k], pit[:, k]
    pj, bj = pjt[:, :k], pjt[:, k]
    x = bi - bj + (pu * (pi - pj)).sum(1)
    # log(1 + exp(-x)); softplus would switch to its linear branch
    per = torch.logaddexp(x.new_zeros(()), -x)
    if mode == "l2":
        reg = 0.5 * ((pu * pu).sum(1) * lu + (pi * pi).sum(1) * li
                     + (pj * pj).sum(1) * lj) + 0.5 * lb * (bi * bi + bj * bj)
    else:
        reg = (pu.abs().sum(1) * lu + pi.abs().sum(1) * li
               + pj.abs().sum(1) * lj + lb * (bi.abs() + bj.abs()))
    tot = per + reg
    if weight is not None:
        tot = tot * weight
    return tot.sum()


class BPRTables(nn.Module):
    """The trained state as buffers: the user table ``ue`` [n_users, k], the
    item table ``iet`` [n_items, k + 1] whose column ``k`` is the item bias,
    and their RMSProp accumulators ``ms_u`` and ``ms_it``."""

    def __init__(self, ue: torch.Tensor, ie: torch.Tensor, ib: torch.Tensor):
        super().__init__()
        self.k = ue.shape[1]
        self.register_buffer("ue", ue.float().contiguous())
        self.register_buffer(
            "iet", torch.cat([ie.float(), ib.float().reshape(-1, 1)], 1))
        self.register_buffer("ms_u", torch.zeros_like(self.ue))
        self.register_buffer("ms_it", torch.zeros_like(self.iet))

    def params(self) -> Dict[str, torch.Tensor]:
        """{"ue", "ie", "ib"}: views of the tables, in the JAX layout."""
        k = self.k
        return {"ue": self.ue, "ie": self.iet[:, :k], "ib": self.iet[:, k]}

    def ms(self) -> Dict[str, torch.Tensor]:
        """{"ue", "ie", "ib"}: views of the accumulators."""
        k = self.k
        return {"ue": self.ms_u, "ie": self.ms_it[:, :k],
                "ib": self.ms_it[:, k]}

    @torch.no_grad()
    def load(self, params=None, ms=None) -> None:
        """Copy ``params`` and/or ``ms`` ({"ue", "ie", "ib"} of arrays or
        tensors, shapes as :meth:`params`) into the buffers."""
        for src, dst in ((params, self.params()), (ms, self.ms())):
            for name, view in ([] if src is None else dst.items()):
                val = src[name]
                if not isinstance(val, torch.Tensor):
                    val = torch.from_numpy(np.asarray(val, np.float32))
                view.copy_(val.reshape(view.shape))


def run_chunk(
    tables: BPRTables,
    u_steps: torch.Tensor,   # [S, B] user rows per step
    i_steps: torch.Tensor,   # [S, B] positive items
    j_steps: torch.Tensor,   # [S, B] negative items
    hyper: Dict[str, float],
    mode: str,
) -> torch.Tensor:
    """Run ``S`` BPR/RMSProp steps on the given triplets, updating
    ``tables`` in place; returns the summed loss as a 0-d tensor on the
    device (no host sync)."""
    lu, li, lj, lb, lr = (hyper[n] for n in ("lu", "li", "lj", "lb", "lr"))
    k = tables.k
    b = u_steps.shape[1]
    uniq_u, seg_u = plan_sparse_updates(u_steps)
    uniq_ij, seg_ij = plan_sparse_updates(torch.cat([i_steps, j_steps], 1))
    losses = []
    for s in range(u_steps.shape[0]):
        with span("train.step"):
            # one gather of unique rows per table; the rows of each
            # occurrence come from those (bpr.py:256-268)
            rows_u, acc_u = planned_rows(tables.ue, tables.ms_u, uniq_u[s])
            rows_ij, acc_ij = planned_rows(tables.iet, tables.ms_it,
                                           uniq_ij[s])
            with torch.enable_grad():
                pu = rows_u[seg_u[s]].requires_grad_()
                pit = rows_ij[seg_ij[s, :b]].requires_grad_()
                pjt = rows_ij[seg_ij[s, b:]].requires_grad_()
                with span("train.grad"):
                    loss = _pairwise_loss(pu, pit, pjt, lu, li, lj, lb,
                                          mode, k)
                    gu, gi, gj = torch.autograd.grad(loss, (pu, pit, pjt))
            agg_u = torch.zeros_like(rows_u).index_add_(0, seg_u[s], gu)
            agg_ij = torch.zeros_like(rows_ij).index_add_(
                0, seg_ij[s], torch.cat([gi, gj]))
            apply_planned_rmsprop(tables.ue, tables.ms_u, uniq_u[s], rows_u,
                                  acc_u, agg_u, lr)
            apply_planned_rmsprop(tables.iet, tables.ms_it, uniq_ij[s],
                                  rows_ij, acc_ij, agg_ij, lr)
            losses.append(loss.detach())
    return torch.stack(losses).sum()


def run_chunk_fused(
    tables: BPRTables,
    u_steps: torch.Tensor,   # [S, B] user rows per step
    i_steps: torch.Tensor,   # [S, B] positive items
    j_steps: torch.Tensor,   # [S, B] negative items
    hyper: Dict[str, float],
    mode: str,
) -> torch.Tensor:
    """:func:`run_chunk` on one [n_users + n_items, k + 1] table built for
    the chunk (bpr.py:172-240); the result is written back into ``tables``.

    The user rows' bias column is never read by the loss, so its gradient
    is 0 and RMSProp keeps it, and its accumulator, at exactly 0."""
    lu, li, lj, lb, lr = (hyper[n] for n in ("lu", "li", "lj", "lb", "lr"))
    k = tables.k
    n_users = tables.ue.shape[0]
    b = u_steps.shape[1]
    uniq, seg = plan_sparse_updates(
        torch.cat([u_steps, i_steps + n_users, j_steps + n_users], 1))
    tbl, mtbl = fuse_tables(tables)
    losses = []
    for s in range(u_steps.shape[0]):
        with span("train.step"):
            rows, acc = planned_rows(tbl, mtbl, uniq[s])
            with torch.enable_grad():
                pu = rows[seg[s, :b], :k].requires_grad_()
                pit = rows[seg[s, b:2 * b]].requires_grad_()
                pjt = rows[seg[s, 2 * b:]].requires_grad_()
                with span("train.grad"):
                    loss = _pairwise_loss(pu, pit, pjt, lu, li, lj, lb,
                                          mode, k)
                    gu, gi, gj = torch.autograd.grad(loss, (pu, pit, pjt))
            # in the plan's order [u | i | j], the users' bias gradient 0
            agg = torch.zeros_like(rows).index_add_(
                0, seg[s], torch.cat([F.pad(gu, (0, 1)), gi, gj]))
            apply_planned_rmsprop(tbl, mtbl, uniq[s], rows, acc, agg, lr)
            losses.append(loss.detach())
    unfuse_tables(tables, tbl, mtbl)
    return torch.stack(losses).sum()


def fuse_tables(tables: BPRTables) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused table [ue ‖ 0 ; ie ‖ ib] and its accumulator, new copies
    of ``tables``' buffers."""
    return (torch.cat([F.pad(tables.ue, (0, 1)), tables.iet]),
            torch.cat([F.pad(tables.ms_u, (0, 1)), tables.ms_it]))


def unfuse_tables(tables: BPRTables, tbl: torch.Tensor,
                  mtbl: torch.Tensor) -> None:
    """Copy a fused table and its accumulator back into ``tables``."""
    n_users, k = tables.ue.shape
    tables.ue.copy_(tbl[:n_users, :k])
    tables.iet.copy_(tbl[n_users:])
    tables.ms_u.copy_(mtbl[:n_users, :k])
    tables.ms_it.copy_(mtbl[n_users:])


# The JAX package's rule for the fused layout under "auto"
# (topk_rec_tpu/models/bpr.py:337, 346, 515-518), under its names: a batch
# of at least this many triplets ...
_FUSED_LAYOUT_MIN_BATCH = 2048
# ... on a table of at most this many rows, since the fused table is built
# anew (a copy of both tables) for every chunk.
_FUSED_LAYOUT_MAX_ROWS = 262_144


def fused_layout(table_layout: str, batch_size: int, n_rows: int) -> bool:
    """Whether ``table_layout`` runs the fused table for ``batch_size``
    triplets per step on ``n_rows`` = n_users + n_items rows."""
    return table_layout == "fused" or (
        table_layout == "auto" and batch_size >= _FUSED_LAYOUT_MIN_BATCH
        and n_rows <= _FUSED_LAYOUT_MAX_ROWS)


class BPR(Recommender):
    """Bayesian Personalized Ranking with device-side sampling.

    Defaults mirror reference single/bpr.py:20: lambda_u = lambda_i =
    2.5e-3, lambda_j = 2.5e-4, lambda_b = 0, lr = 1e-4, mode "l2" or "l1".
    ``membership`` picks the sampler's store (``ops/sampling.py``);
    ``table_layout`` is "separate", "fused" or "auto" (:func:`fused_layout`).
    """

    def __init__(
        self,
        k: int,
        lambda_u: float = 2.5e-3,
        lambda_i: float = 2.5e-3,
        lambda_j: float = 2.5e-4,
        lambda_b: float = 0.0,
        lr: float = 1.0e-4,
        mode: str = "l2",
        seed: int = 0,
        k_candidates: int = 2,
        table_layout: str = "auto",
        membership: str = "auto",
        device="cuda",
    ):
        super().__init__(k, device)
        if mode not in ("l2", "l1"):
            raise ValueError(f"mode must be l2|l1, got {mode!r}")
        if table_layout not in ("auto", "separate", "fused"):
            raise ValueError(
                f"table_layout must be auto|separate|fused, got "
                f"{table_layout!r}")
        if membership not in ("auto", "bitmap", "sorted"):
            raise ValueError(
                f"membership must be auto|bitmap|sorted, got {membership!r}")
        self.lu, self.li, self.lj, self.lb = (lambda_u, lambda_i, lambda_j,
                                              lambda_b)
        self.lr = lr
        self.mode = mode
        self.seed = seed
        self.k_candidates = k_candidates
        self.table_layout = table_layout
        self.membership = membership
        self.sampler: Optional[TripletSampler] = None
        self.tables: Optional[BPRTables] = None

    def _on_data_loaded(self) -> None:
        self.sampler = TripletSampler(self.inter, self.k_candidates,
                                      membership=self.membership,
                                      device=self.device)

    def hyper(self) -> Dict[str, float]:
        return {"lu": self.lu, "li": self.li, "lj": self.lj, "lb": self.lb,
                "lr": self.lr}

    # ---- parameter init / sync ----

    def _init_params(self, gen: torch.Generator) -> None:
        """N(0, 0.01) embeddings and zero biases (ref bpr.py:77-79), except
        for warm-start tables already loaded (ref bpr.py:120-135); zero
        accumulators."""
        dev = self.device

        def table(host, n):
            if host is not None:
                return torch.as_tensor(np.asarray(host, np.float32)).to(dev)
            return 0.01 * torch.randn(n, self.k, generator=gen, device=dev)

        ue = table(self.fue, self.n_users)
        ie = table(self.fie, self.n_items)
        ib = (torch.zeros(self.n_items, device=dev) if self.fib is None else
              torch.as_tensor(np.asarray(self.fib, np.float32)).to(dev))
        self.tables = BPRTables(ue, ie, ib.reshape(-1))

    def _sync_host(self) -> None:
        p = self.tables.params()
        self.fue = p["ue"].cpu().numpy()
        self.fie = p["ie"].cpu().numpy()
        self.fib = p["ib"].cpu().numpy().reshape(-1, 1)

    # ---- training ----

    def sample_chunk(self, gen: torch.Generator, n_steps: int,
                     batch_size: int) -> Tuple[torch.Tensor, ...]:
        """(u, i, j), each [n_steps, batch_size], in one sampler call."""
        with span("train.sample"):
            trip = self.sampler(gen, n_steps * batch_size)
        return tuple(t.view(n_steps, batch_size) for t in trip)

    def picks_fused(self, batch_size: int) -> bool:
        """Whether :meth:`train` runs the fused layout at ``batch_size``."""
        return fused_layout(self.table_layout, batch_size,
                            self.n_users + self.n_items)

    def train_chunk(self, gen: torch.Generator, n_steps: int,
                    batch_size: int, fused: bool = False) -> torch.Tensor:
        """Sample and run one chunk, on the fused table if ``fused``; the
        summed loss stays on the device."""
        with span("train.chunk"):
            u, i, j = self.sample_chunk(gen, n_steps, batch_size)
            chunk = run_chunk_fused if fused else run_chunk
            return chunk(self.tables, u, i, j, self.hyper(), self.mode)

    def train(
        self,
        epochs: int = 5,
        batch_size: int = 256,
        epoch_sample_limit: Optional[int] = None,
        model_path: Optional[str] = None,
        scan_steps: int = 128,
        verbose: bool = True,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 1,
    ) -> None:
        """Reference-parity training loop (bpr.py:436-559).

        Each epoch runs ``epoch_sample_limit // batch_size + 1`` batches
        (default limit: the positive pairs, ref bpr.py:113), rounded up to
        whole chunks of ``scan_steps``. ``model_path`` warm-starts from
        exported tables. ``ckpt_dir`` saves tables and accumulators every
        ``ckpt_every`` epochs and resumes from the latest checkpoint, which
        reproduces the uninterrupted run. One host sync per epoch reads the
        loss.
        """
        if self.inter is None:
            raise ValueError("no training data loaded")
        if epoch_sample_limit is None:
            epoch_sample_limit = self.inter.nnz
        batch_limit = int(epoch_sample_limit) // batch_size + 1
        if model_path is not None:
            tprint("Initialize weights with the previous trained model")
            self.import_embeddings(model_path)
        self._init_params(stream_generator(self.seed, INIT_STREAM,
                                           self.device))
        start_epoch = 0
        mgr = None
        if ckpt_dir is not None:
            mgr = CheckpointManager(ckpt_dir, save_every=ckpt_every)
            latest = mgr.latest_step()
            if latest is not None:
                state = mgr.restore(latest)
                self.tables.load(state["params"], state["ms"])
                start_epoch = latest
                if verbose:
                    tprint(f"Resuming from checkpointed epoch {latest}")
        n_chunks = max(1, -(-batch_limit // scan_steps))
        fused = self.picks_fused(batch_size)
        if verbose:
            tprint("Training parameters: lu=%.6f, li=%.6f, lj=%.6f, lb=%.6f"
                   % (self.lu, self.li, self.lj, self.lb))
            tprint("Learning rate is %.6f, regularization mode is %s"
                   % (self.lr, self.mode))
            tprint("Training for %d epochs of %d batches (batch %d, %d per "
                   "chunk) on %s, %s tables"
                   % (epochs, n_chunks * scan_steps, batch_size, scan_steps,
                      self.device, "fused" if fused else "separate"))
        for eid in range(start_epoch, epochs):
            t0 = time.time()
            gen = stream_generator(self.seed, eid, self.device)
            losses = [self.train_chunk(gen, scan_steps, batch_size, fused)
                      for _ in range(n_chunks)]
            total_loss = float(torch.stack(losses).sum())
            if verbose:
                tprint("Epoch %3d, loss %.4f, time %.3fs"
                       % (eid + 1, total_loss, time.time() - t0))
            if mgr is not None:
                mgr.save(eid + 1, {"params": self.tables.params(),
                                   "ms": self.tables.ms()})
        self._sync_host()

    # ---- native checkpoint ----

    def _native_state(self) -> Dict[str, np.ndarray]:
        if self.tables is None:
            return {}
        return {f"ms_{n}": t.cpu().numpy()
                for n, t in self.tables.ms().items()}

    def _load_native_state(self, state) -> None:
        """Tables from the imported ``final-*.dat`` and accumulators from
        ``checkpoint.npz`` (bpr.py:572-578)."""
        if "ms_ue" not in state:
            return
        if self.fue is None or self.fie is None:
            raise ValueError(
                "checkpoint.npz needs final-U.dat and final-V.dat beside it")
        self._init_params(stream_generator(self.seed, INIT_STREAM,
                                           self.device))
        self.tables.load(ms={n: state[f"ms_{n}"] for n in ("ue", "ie", "ib")})
