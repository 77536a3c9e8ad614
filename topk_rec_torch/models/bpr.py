"""BPR: pairwise-ranking matrix factorization (counterpart of
``topk_rec_tpu/models/bpr.py``).

The model scores x_ui = <u_e, i_e> + b_i and minimizes the pairwise
softplus loss with l2 or l1 regularization (reference single/bpr.py:87-99),
with sparse RMSProp (``ops/sparse_update.py``). Defaults mirror reference
bpr.py:20.

The sampler, the step loop and the epoch loop are the pairwise trainers'
(``models/pairwise.py``). BPR owns its loss (:func:`_pairwise_loss`), its
tables (:class:`BPRTables`; the item bias is column ``k`` of the item
table, bpr.py:248-254), its header lines and its two table layouts, each a
statement of the shared step loop: :func:`run_chunk` on the user and the
item table, and :func:`run_chunk_fused` on one [n_users + n_items, k + 1]
table (bpr.py:172-240), one plan, gather, ``index_add_`` and RMSProp
update a step where the separate tables take two of each.
:meth:`BPR.train` picks the fused layout as the JAX package does
(bpr.py:515-518): when asked, or under ``auto`` for a batch of at least
:data:`_FUSED_LAYOUT_MIN_BATCH` on at most :data:`_FUSED_LAYOUT_MAX_ROWS`
rows. Both layouts compute the same arithmetic on disjoint row ranges, and
the sampler draws the same triplets under either.

The BPR step has no Pallas kernel in the JAX package (it is XLA gathers,
segment sums and scatters), so here it is plain PyTorch: a few dozen small
launches per step, whose overhead sets the pace at batch 256.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sparse_update import apply_planned_rmsprop
from ..tracing import span
from ..utils import tprint
from .pairwise import (
    INIT_STREAM,
    Leaf,
    PairwiseRecommender,
    SparseTable,
    run_planned_steps,
    stream_generator,
)


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
    b = u_steps.shape[1]
    return run_planned_steps(
        [SparseTable(tables.ue, tables.ms_u, u_steps, (Leaf(0, b),)),
         SparseTable(tables.iet, tables.ms_it,
                     torch.cat([i_steps, j_steps], 1),
                     (Leaf(0, b), Leaf(b, 2 * b)))],
        (), _pairwise_loss, (hyper["lu"], hyper["li"], hyper["lj"],
                             hyper["lb"], mode, tables.k),
        apply_planned_rmsprop, None, hyper["lr"])


def run_chunk_fused(
    tables: BPRTables,
    u_steps: torch.Tensor,   # [S, B] user rows per step
    i_steps: torch.Tensor,   # [S, B] positive items
    j_steps: torch.Tensor,   # [S, B] negative items
    hyper: Dict[str, float],
    mode: str,
) -> torch.Tensor:
    """:func:`run_chunk` on one [n_users + n_items, k + 1] table built for
    the chunk (bpr.py:172-240) at [u ‖ i + n_users ‖ j + n_users]; the
    result is written back into ``tables``.

    The user leaf reads the first ``k`` columns, so the user rows' bias
    column gets a zero gradient and RMSProp keeps it, and its accumulator,
    at exactly 0."""
    n_users, k = tables.ue.shape
    b = u_steps.shape[1]
    idx = torch.cat([u_steps, i_steps + n_users, j_steps + n_users], 1)
    tbl, mtbl = fuse_tables(tables)
    loss = run_planned_steps(
        [SparseTable(tbl, mtbl, idx,
                     (Leaf(0, b, k), Leaf(b, 2 * b), Leaf(2 * b, 3 * b)))],
        (), _pairwise_loss, (hyper["lu"], hyper["li"], hyper["lj"],
                             hyper["lb"], mode, k),
        apply_planned_rmsprop, None, hyper["lr"])
    unfuse_tables(tables, tbl, mtbl)
    return loss


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


class BPR(PairwiseRecommender):
    """Bayesian Personalized Ranking with device-side sampling.

    Defaults mirror reference single/bpr.py:20: lambda_u = lambda_i =
    2.5e-3, lambda_j = 2.5e-4, lambda_b = 0, lr = 1e-4, mode "l2" or "l1".
    ``membership`` picks the sampler's store (``ops/sampling.py``);
    ``table_layout`` is "separate", "fused" or "auto" (:func:`fused_layout`).
    """

    SCAN_STEPS = 128  # JAX's default for BPR

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
        super().__init__(k, lambda_u, lambda_i, lambda_j, lambda_b, lr, mode,
                         seed, k_candidates, membership, device)
        if table_layout not in ("auto", "separate", "fused"):
            raise ValueError(
                f"table_layout must be auto|separate|fused, got "
                f"{table_layout!r}")
        self.table_layout = table_layout

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

    def picks_fused(self, batch_size: int) -> bool:
        """Whether :meth:`train` runs the fused layout at ``batch_size``."""
        return fused_layout(self.table_layout, batch_size,
                            self.n_users + self.n_items)

    def _chunk_args(self, batch_size: int) -> tuple:
        return (self.picks_fused(batch_size),)

    def _print_header(self, epochs: int, batches: int, batch_size: int,
                      scan_steps: int, fused: bool) -> None:
        tprint("Training parameters: lu=%.6f, li=%.6f, lj=%.6f, lb=%.6f"
               % (self.lu, self.li, self.lj, self.lb))
        tprint("Learning rate is %.6f, regularization mode is %s"
               % (self.lr, self.mode))
        tprint("Training for %d epochs of %d batches (batch %d, %d per "
               "chunk) on %s, %s tables"
               % (epochs, batches, batch_size, scan_steps, self.device,
                  "fused" if fused else "separate"))

    def train_chunk(self, gen: torch.Generator, n_steps: int,
                    batch_size: int, fused: bool = False) -> torch.Tensor:
        """Sample and run one chunk, on the fused table if ``fused``; the
        summed loss stays on the device."""
        with span("train.chunk"):
            u, i, j = self.sample_chunk(gen, n_steps, batch_size)
            chunk = run_chunk_fused if fused else run_chunk
            return chunk(self.tables, u, i, j, self.hyper(), self.mode)

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
