"""Explicit all-to-all embedding lookup and update over row-sharded tables
(counterpart of ``topk_rec_tpu/parallel/lookup.py``).

Each function here runs on every rank of the mesh axis (the SPMD body that
JAX runs under ``shard_map``), on this rank's block of rows of the table
and this rank's slice of the batch:

1. sort and dedup the local indices (a stable sort, so the segment map
   and which uniques overflow are JAX's); pad slots carry the sentinel
   ``2**31 - 1``;
2. owners are contiguous runs of the sorted uniques (row-block sharding),
   so the [S, C] send buffer fills by run offset; uniques beyond a
   destination's capacity C are dropped and counted;
3. ``all_to_all_single`` sends the indices to their owners, each owner
   serves its rows, and a second ``all_to_all_single`` sends them back;
4. the unique rows expand to the occurrence order through the segment map;
   dropped uniques come back as zero rows, flagged by the validity mask.

The reverse direction (:func:`sharded_update`, :func:`_exchange_rmsprop`)
sums each source's duplicates first, routes the sums the same way, and has
the owner dedup what arrived from all sources, so that a row sees one
update on the sum of its gradients.

JAX's ``mode="drop"`` scatters have no torch counterpart: here a dropped
slot is sent to a dump slot one past the buffer, which is then cut off,
and the table writes route padded slots to a row that takes its own value
(:func:`_write_rows`). Nothing is clamped into a live slot. The shapes are
static, as in JAX: no step waits for the device. The port runs eagerly, so
JAX's jit memo (``_JIT_CACHE``) has no counterpart.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .distributed import all_gather_rows, all_to_all

SENTINEL = 2**31 - 1


def _dedup_sorted(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted uniques (sentinel-padded) and the occurrence -> slot segment
    map of a 1-D int64 index vector (lookup.py:85-94)."""
    b = idx.shape[0]
    sidx, order = torch.sort(idx, stable=True)
    first = torch.ones(b, dtype=torch.bool, device=idx.device)
    first[1:] = sidx[1:] != sidx[:-1]
    slot_sorted = first.long().cumsum(0) - 1
    seg = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted)
    # the duplicates of a run write the same value into the same slot
    uniq = torch.full_like(sidx, SENTINEL).scatter_(0, slot_sorted, sidx)
    return uniq, seg


def _build_send(uniq, n_shards: int, rows_per_shard: int, capacity: int):
    """Route sorted uniques into the [S, C] send buffer (lookup.py:97-125).

    Returns (send [S, C], dst [b], ok [b], overflow): ``dst`` is each
    unique's flat slot ``owner·C + position`` in the buffer, or the dump
    slot ``S·C`` where it was not sent (``ok`` False)."""
    b = uniq.shape[0]
    dev = uniq.device
    live = uniq != SENTINEL
    owner = torch.where(live, uniq // rows_per_shard, n_shards)
    start = torch.searchsorted(owner, torch.arange(n_shards, device=dev))
    pos = (torch.arange(b, device=dev)
           - start[owner.clamp(max=n_shards - 1)])
    ok = live & (pos < capacity)
    overflow = (live & ~ok).sum()
    dump = n_shards * capacity
    dst = torch.where(ok, owner * capacity + pos, dump)
    send = torch.full((dump + 1,), SENTINEL, dtype=uniq.dtype, device=dev)
    send.scatter_(0, dst, uniq)
    return send[:dump].view(n_shards, capacity), dst, ok, overflow


class _Route:
    """The forward exchange of one index batch over one mesh axis: the
    dedup, the request ``all_to_all`` and what this owner was asked for.
    :meth:`gather` serves any table row-sharded like the one the indices
    address (its second ``all_to_all``), so tables that share rows share
    one route."""

    def __init__(self, idx_local: torch.Tensor, mesh, axis: str,
                 rows_per_shard: int, capacity: int):
        self.shape = idx_local.shape
        self.group = mesh.groups[axis]
        self.n_shards = mesh.shape[axis]
        self.capacity = capacity
        self.uniq, self.seg = _dedup_sorted(idx_local.reshape(-1).long())
        send, self.dst, self.ok, self.overflow = _build_send(
            self.uniq, self.n_shards, rows_per_shard, capacity)
        recv = all_to_all(send, self.group)
        self.served = (recv != SENTINEL).unsqueeze(-1)
        # a read index: clamped, then masked by ``served``
        self.rows = (recv - mesh.coords[axis] * rows_per_shard).clamp(
            0, rows_per_shard - 1)

    def gather(self, table_local: torch.Tensor) -> torch.Tensor:
        """Rows of ``table_local``'s table at the route's indices, in
        occurrence order (shape of the indices + [k]); zero rows where the
        unique overflowed."""
        k = table_local.shape[1]
        served = torch.where(self.served, table_local[self.rows], 0)
        back = all_to_all(served, self.group).reshape(-1, k)
        at = self.dst.clamp(max=back.shape[0] - 1)
        uniq_rows = torch.where(self.ok.unsqueeze(1), back[at], 0)
        return uniq_rows[self.seg].reshape(*self.shape, k)

    def valid(self) -> torch.Tensor:
        """Per occurrence: False where its unique overflowed."""
        return self.ok[self.seg].reshape(self.shape)


def _exchange(table_local, idx_local, mesh, axis: str, rows_per_shard: int,
              capacity: int, with_valid: bool = False):
    """The lookup body (lookup.py:128-169): rows of the table at this
    rank's indices, and int32 [1] of uniques dropped here. ``with_valid``
    also returns the per-occurrence validity mask (False where the row is a
    zero stand-in), with which the explicit-exchange trainer voids those
    examples."""
    route = _Route(idx_local, mesh, axis, rows_per_shard, capacity)
    out = route.gather(table_local)
    ovf = route.overflow.reshape(1).int()
    if with_valid:
        return out, route.valid(), ovf
    return out, ovf


def _local_batch(idx, mesh, axis: str) -> Tuple[torch.Tensor, int]:
    """This rank's slice of the full batch ``idx`` (split over ``axis``)."""
    n = mesh.shape[axis]
    idx = torch.as_tensor(idx).to(mesh.device)
    if idx.shape[0] % n:
        raise ValueError(f"batch {idx.shape[0]} does not divide the {axis} "
                         f"axis ({n})")
    bl = idx.shape[0] // n
    at = mesh.coords[axis] * bl
    return idx[at:at + bl], bl


def default_capacity(b_local: int, n_shards: int) -> int:
    """``2·ceil(b_local / S)``: twice a uniform spread (lookup.py:199-200)."""
    return 2 * (-(-b_local // n_shards))


def sharded_lookup(table_local, idx, mesh, axis: str = "mp",
                   capacity: int = 0):
    """Gather ``table[idx]`` through the deduplicated all-to-all exchange
    (lookup.py:172-214).

    Every rank of the axis passes its block of rows of the table
    (``table_local``, the rows split evenly over the axis) and the same
    full batch ``idx`` [B] (B must divide the axis). ``capacity`` is the
    request slots per destination; 0 picks ``2·ceil(B_local / S)``.

    Returns (this rank's rows [B/S, k], the uniques dropped per rank of
    the axis, int32 [S]; all zero means the gather is exact).
    """
    n = mesh.shape[axis]
    mine, bl = _local_batch(idx, mesh, axis)
    if capacity <= 0:
        capacity = default_capacity(bl, n)
    rows, ovf = _exchange(table_local, mine, mesh, axis,
                          table_local.shape[0], capacity)
    return rows, all_gather_rows(ovf, mesh.groups[axis])


# ---------------------------------------------------------------------------
# reverse exchange: updates back to the owning shards
# ---------------------------------------------------------------------------


def _route_contributions(idx_local, rows_local, mesh, axis: str,
                         rows_per_shard: int, capacity: int):
    """The reverse routing (lookup.py:222-257): this rank's contributions
    summed per unique row, sent to the owners in the [S, C] layout of the
    lookup. Returns (owner-local row [S·C] with the sentinel in dead slots,
    the rows received [S·C, k], overflow)."""
    idx = idx_local.reshape(-1).long()
    b = idx.shape[0]
    k = rows_local.shape[-1]
    n_shards = mesh.shape[axis]
    group = mesh.groups[axis]
    uniq, seg = _dedup_sorted(idx)
    gsum = torch.zeros((b, k), dtype=rows_local.dtype,
                       device=rows_local.device).index_add_(
                           0, seg, rows_local.reshape(b, k))
    send_idx, dst, _, overflow = _build_send(uniq, n_shards, rows_per_shard,
                                             capacity)
    dump = n_shards * capacity
    send_rows = torch.zeros((dump + 1, k), dtype=gsum.dtype,
                            device=gsum.device).index_copy_(0, dst, gsum)
    recv_idx = all_to_all(send_idx, group)
    recv_rows = all_to_all(send_rows[:dump].view(n_shards, capacity, k),
                           group)
    local = torch.where(recv_idx == SENTINEL, SENTINEL,
                        recv_idx - mesh.coords[axis] * rows_per_shard)
    return local.reshape(-1), recv_rows.reshape(-1, k), overflow


def _owner_sums(local: torch.Tensor, rows: torch.Tensor, n_rows: int):
    """The owner's second dedup (lookup.py:299-306): the distinct rows
    that arrived (past ``n_rows`` in the padded slots) and the sum of each
    one's contributions. ``index_put_`` with ``accumulate`` sums in a fixed
    order, so ranks holding the same inputs get the same bits.

    Each dead slot (the sentinel: nothing was sent there) gets an index of
    its own past the table. On the card the accumulation walks a run of
    equal indices in one warp, so a single segment holding every dead slot
    of a [S·C] buffer (most of it at a large batch) would serialize."""
    n = local.shape[0]
    local = torch.where(local == SENTINEL,
                        n_rows + torch.arange(n, device=local.device), local)
    uniq, seg = _dedup_sorted(local)
    sums = torch.zeros_like(rows).index_put_((seg,), rows, accumulate=True)
    return uniq, sums


def _read_rows(table: torch.Tensor, uniq: torch.Tensor) -> torch.Tensor:
    """table[uniq], with 0 in the padded slots."""
    live = (uniq < table.shape[0]).unsqueeze(1)
    return torch.where(live, table[torch.where(live[:, 0], uniq, 0)], 0)


def _write_rows(table: torch.Tensor, uniq: torch.Tensor,
                rows: torch.Tensor) -> None:
    """table[uniq] = rows for the live slots. The padded slots (the tail,
    ``uniq`` being sorted) rewrite slot 0's row with slot 0's value, or row
    0 with its own value when no slot is live: a row written twice with one
    value is written once, and a rank that received nothing changes
    nothing."""
    live = uniq < table.shape[0]
    any_live = live[:1]
    fill_row = torch.where(any_live, uniq[:1], 0)
    fill = torch.where(any_live.unsqueeze(1), rows[:1], table[:1])
    table.index_copy_(0, torch.where(live, uniq, fill_row),
                      torch.where(live.unsqueeze(1), rows, fill))


def _exchange_scatter(table_local, idx_local, rows_local, mesh, axis: str,
                      rows_per_shard: int, capacity: int):
    """The reverse body (lookup.py:260-276): contributions for this rank's
    indices added, in place, to the rows their owners hold. A dropped
    unique loses its whole contribution, as if its examples were removed.
    Returns (table_local, int32 [1] uniques dropped here)."""
    local, recv_rows, overflow = _route_contributions(
        idx_local, rows_local, mesh, axis, rows_per_shard, capacity)
    uniq, sums = _owner_sums(local, recv_rows, table_local.shape[0])
    _write_rows(table_local, uniq, _read_rows(table_local, uniq) + sums)
    return table_local, overflow.reshape(1).int()


def _exchange_rmsprop(table_local, acc_local, idx_local, grads_local, mesh,
                      axis: str, rows_per_shard: int, capacity: int,
                      lr: float, decay: float = 0.9, eps: float = 1e-10,
                      replicas: Optional[str] = None):
    """The reverse exchange with the owner-side sparse RMSProp
    (lookup.py:279-312): one accumulator update per globally touched row,
    on the sum of all its gradients, in place.

    ``replicas`` names a mesh axis over which the table is replicated (the
    "dp" axis of a dp x mp mesh): each owner first gathers what its
    replicas received, so that every replica applies the same update on
    the gradient summed over the whole batch and the replicas stay
    bitwise equal.

    As in JAX, a row whose summed gradient is zero (every triplet that
    touched it was voided upstream) still gets the apply: its accumulator
    decays by ``decay`` and the row does not move.
    Returns (table_local, acc_local, int32 [1] uniques dropped here).
    """
    local, recv_rows, overflow = _route_contributions(
        idx_local, grads_local, mesh, axis, rows_per_shard, capacity)
    if replicas is not None and mesh.shape[replicas] > 1:
        group = mesh.groups[replicas]
        local = all_gather_rows(local, group)
        recv_rows = all_gather_rows(recv_rows, group)
    uniq, g = _owner_sums(local, recv_rows, table_local.shape[0])
    acc_new = decay * _read_rows(acc_local, uniq) + (1.0 - decay) * g * g
    upd = _read_rows(table_local, uniq) - lr * g / torch.sqrt(acc_new + eps)
    _write_rows(table_local, uniq, upd)
    _write_rows(acc_local, uniq, acc_new)
    return table_local, acc_local, overflow.reshape(1).int()


def sharded_update(table_local, idx, rows, mesh, axis: str = "mp",
                   capacity: int = 0):
    """Add ``rows`` into the table at ``idx`` through the reverse exchange
    (lookup.py:315-362), in place on each rank's block of rows.

    Every rank passes its ``table_local`` and the same full ``idx`` [B]
    (duplicates allowed: their contributions sum) and ``rows`` [B, k];
    ``capacity`` as in :func:`sharded_lookup`.

    Returns (table_local, uniques dropped per rank of the axis, int32 [S]).
    """
    n = mesh.shape[axis]
    mine, bl = _local_batch(idx, mesh, axis)
    rows_mine, _ = _local_batch(rows, mesh, axis)
    if capacity <= 0:
        capacity = default_capacity(bl, n)
    table_local, ovf = _exchange_scatter(
        table_local, mine, rows_mine, mesh, axis, table_local.shape[0],
        capacity)
    return table_local, all_gather_rows(ovf, mesh.groups[axis])
