"""Sparse row-wise RMSProp (counterpart of
``topk_rec_tpu/ops/sparse_update.py``).

TF1 IndexedSlices semantics, as the reference's embedding training had
them: the gradients of duplicate rows are summed, each touched row's
accumulator advances once (decay 0.9, eps 1e-10 inside the sqrt), and rows
the batch does not touch stay bitwise unchanged.

The plan has a fixed size, as in JAX (sparse_update.py:30-67): a batched
sort, first-of-run flags and a cumsum give, for each step, ``uniq`` (the
distinct rows, padded with the sentinel ``2**31 - 1``) and ``seg`` (each
batch position's slot in ``uniq``). ``torch.unique`` is not used: its output
size depends on the data, so on CUDA it waits for the device on every call.

JAX reads padded slots as 0 and drops writes to them (``mode="fill"`` /
``"drop"``); torch raises on an index out of range. Here a padded slot reads
row 0 and is then zeroed, and it writes the row and value of slot 0, the
smallest real row of the step: a row written twice with one value is the
same as a row written once, so the result does not depend on the order of
the writes and needs no host sync.

The updates are in place: :func:`apply_planned_rmsprop`,
:func:`planned_rmsprop` and :func:`sparse_rmsprop` write into ``table`` and
``acc`` (a 1-D table through a [n, 1] view) and return them, which saves a
copy of the whole table per step. Summing duplicates uses ``index_add_``,
whose order on CUDA is that of atomics, so the card's sums may differ in the
last bit from run to run; on the CPU they are reproducible.
"""

from __future__ import annotations

from typing import Tuple

import torch

PAD = 2**31 - 1  # the plan's padding sentinel, as in the JAX package


def plan_sparse_updates(
    idx_all: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Duplicate-aggregation plan for a chunk of steps.

    Args:
      idx_all: integer ``[S, M]`` row indices per step (duplicates allowed).

    Returns ``(uniq, seg)``, int64 ``[S, M]`` each: the distinct rows of
    each step in ascending order, padded with :data:`PAD`, and each batch
    position's slot in ``uniq``.
    """
    idx_all = idx_all.long()
    sidx, order = torch.sort(idx_all, dim=1)
    first = torch.ones_like(sidx, dtype=torch.bool)
    first[:, 1:] = sidx[:, 1:] != sidx[:, :-1]
    seg_sorted = first.long().cumsum(1) - 1
    seg = torch.empty_like(seg_sorted).scatter_(1, order, seg_sorted)
    # duplicates of a run write the same row into the same slot
    uniq = torch.full_like(sidx, PAD).scatter_(1, seg_sorted, sidx)
    return uniq, seg


def planned_rows(
    table: torch.Tensor,   # [n_rows, k]
    acc: torch.Tensor,     # same shape, the second-moment accumulator
    uniq: torch.Tensor,    # [M] distinct rows, PAD-padded (one plan step)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows of (table, accumulator) at ``uniq``; padded slots read 0."""
    live = (uniq < table.shape[0]).unsqueeze(1)
    safe = torch.where(live.squeeze(1), uniq, 0)
    return (torch.where(live, table[safe], 0.0),
            torch.where(live, acc[safe], 0.0))


def _write_rows(table, uniq, rows):
    """table[uniq] = rows, with padded slots sent to slot 0's row and value."""
    live = uniq < table.shape[0]
    dst = torch.where(live, uniq, uniq[:1])
    src = torch.where(live.unsqueeze(1), rows, rows[:1])
    table.index_copy_(0, dst, src)


def apply_planned_rmsprop(
    table: torch.Tensor,     # [n_rows, k], updated in place
    acc: torch.Tensor,       # same shape, updated in place
    uniq: torch.Tensor,      # [M] distinct rows, PAD-padded
    tab_rows: torch.Tensor,  # [M, k] rows gathered by planned_rows
    acc_rows: torch.Tensor,  # [M, k]
    agg: torch.Tensor,       # [M, k] summed gradients per slot
    lr: float,
    decay: float = 0.9,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSProp update of the planned rows from rows gathered beforehand
    (sparse_update.py:90-110); returns (table, acc)."""
    acc_new = decay * acc_rows + (1.0 - decay) * agg * agg
    upd = tab_rows - lr * agg / torch.sqrt(acc_new + eps)
    _write_rows(table, uniq, upd)
    _write_rows(acc, uniq, acc_new)
    return table, acc


def planned_rmsprop(
    table: torch.Tensor,   # [n_rows, k] or [n_rows], updated in place
    acc: torch.Tensor,     # same shape, updated in place
    uniq: torch.Tensor,    # [M] distinct rows, PAD-padded (one plan step)
    seg: torch.Tensor,     # [M] batch position -> slot in uniq
    grads: torch.Tensor,   # [M, k] or [M] gradients per occurrence
    lr: float,
    decay: float = 0.9,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sparse RMSProp step from a plan step; returns (table, acc)."""
    t2, a2, g2 = table, acc, grads
    if table.dim() == 1:
        t2, a2, g2 = table[:, None], acc[:, None], grads[:, None]
    m = uniq.shape[0]
    agg = torch.zeros((m, t2.shape[1]), dtype=g2.dtype,
                      device=g2.device).index_add_(0, seg, g2)
    tab_rows, acc_rows = planned_rows(t2, a2, uniq)
    apply_planned_rmsprop(t2, a2, uniq, tab_rows, acc_rows, agg, lr, decay,
                          eps)
    return table, acc


def sparse_rmsprop(
    table: torch.Tensor,   # [n_rows, k] or [n_rows], updated in place
    acc: torch.Tensor,     # same shape, updated in place
    idx: torch.Tensor,     # [M] touched rows (duplicates allowed)
    grads: torch.Tensor,   # [M, k] or [M] gradients per occurrence
    lr: float,
    decay: float = 0.9,
    eps: float = 1e-10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sparse RMSProp step with its own plan; returns (table, acc)."""
    uniq, seg = plan_sparse_updates(idx.reshape(1, -1))
    return planned_rmsprop(table, acc, uniq[0], seg[0], grads, lr, decay, eps)
