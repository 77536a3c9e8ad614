"""Serving surface: batched top-k recommendation queries on the device.

Counterpart of ``topk_rec_tpu/serving.py``. ``TopKServer`` is an
``nn.Module`` whose tables (U, V, bias, the per-user seen store) are
registered buffers on one device. Four selection methods:

* ``exact``  — U·Vᵀ + bias, seen items -> -inf, stable sort top-k;
* ``approx`` — the same scores through ``approx_topk``, the counterpart of
  ``jax.lax.approx_max_k`` (recall about 0.95; not exact);
* ``kernel`` — the fused score + mask + top-k kernel K1
  (``ops/topk_fused.py``), the counterpart of JAX's ``pallas``, which never
  materializes the [batch, catalog] score matrix;
* ``hybrid`` — ``exact_topk_hybrid`` (``ops/topk_hybrid.py``): the approx
  selector made exact by the threshold-count audit K2 and a re-rank of the
  rows that fail it.

All run with bf16-rounded table inputs and fp32 accumulation, which is what
the TPU's ``Precision.DEFAULT`` does (serving.py:66-68, 103-110), so the
methods rank the same numbers.

With a ``mesh`` (``parallel/mesh.py``), U and the seen store are
row-sharded over "mp" and V and the bias replicated (serving.py:159-177).
Every rank calls ``recommend`` with the same batch: each looks up the
user and seen rows of its slice through the all-to-all exchange
(``parallel/lookup.py``), ranks them with the same ``_query``, and the
slices are all-gathered, so every rank returns the full result.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from .data.dataset import Interactions
from .device import resolve_device
from .parallel.distributed import all_gather_rows
from .parallel.lookup import default_capacity, sharded_lookup
from .parallel.mesh import Mesh
from .tracing import span
from .ops.topk_fused import (
    NEG_INF,
    bitmap_tensor,
    expand_seen_mask,
    fused_score_topk,
    kernel_table,
    pack_mask,
    topk_stable,
)
from .ops.topk_hybrid import approx_topk, exact_topk_hybrid

METHODS = ("exact", "approx", "kernel", "hybrid")


def _lists_mask(seen_rows: torch.Tensor, n_items: int) -> torch.Tensor:
    """Padded per-user item lists [B, D] (pad = n_items) -> bool [B, n_items]
    (serving.py:48-58: the pad slot lands in a throwaway column)."""
    b = seen_rows.shape[0]
    mask = torch.zeros((b, n_items + 1), dtype=torch.bool,
                       device=seen_rows.device)
    mask.scatter_(1, seen_rows.long(), True)
    return mask[:, :n_items]


def _query(
    user_emb: torch.Tensor,     # [B, dim] gathered user rows
    V: torch.Tensor,            # [n_items, dim]
    bias: Optional[torch.Tensor],
    seen_rows: torch.Tensor,    # bitmap: [B, n_words] int32; lists: [B, D]
    k: int,
    method: str,
    n_items: int,
    seen_format: str = "bitmap",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query batch (serving.py:37-86): (scores, item ids), -inf for
    slots past the user's unseen items."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r} (choose from {METHODS})")
    if method in ("kernel", "hybrid"):
        words = (
            pack_mask(_lists_mask(seen_rows, n_items))
            if seen_format == "lists" else seen_rows
        )
        select = fused_score_topk if method == "kernel" else exact_topk_hybrid
        vals, idx = select(user_emb, V, bias, words, k, exact_matmul=False)
        return torch.where(vals <= NEG_INF, -torch.inf, vals), idx
    mask = (
        _lists_mask(seen_rows, n_items)
        if seen_format == "lists"
        else expand_seen_mask(seen_rows, n_items) != 0
    )
    u = user_emb.to(torch.bfloat16).float()
    v = V.to(torch.bfloat16).float()
    scores = u @ v.T
    if bias is not None:
        scores = scores + bias[None, :]
    scores = scores.masked_fill(mask, -torch.inf)
    select = approx_topk if method == "approx" else topk_stable
    vals, idx = select(scores, k)
    return vals, idx.to(torch.int32)


def _query_local(U, V, bias, seen, uid, k, method, n_items, seen_format):
    """serving.py:276-282: gather the batch's user and seen rows, query."""
    return _query(
        U[uid], V, bias, seen[uid], k, method, n_items, seen_format
    )


class TopKServer(nn.Module):
    """Holds one model's tables on a device and answers top-k queries."""

    def __init__(
        self,
        U: np.ndarray,
        V: np.ndarray,
        bias: Optional[np.ndarray] = None,
        interactions: Optional[Interactions] = None,
        exclude_seen: bool = True,
        mesh=None,
        seen_format: str = "bitmap",
        table_dtype: Optional[torch.dtype] = None,
        device="cuda",
    ):
        """``table_dtype=torch.bfloat16`` stores U and V at half the memory;
        scores are unchanged, since every method rounds its inputs to bf16
        (the bias stays fp32). ``seen_format`` picks the per-user seen
        store (serving.py:112-124): ``"bitmap"`` (int32 words, n_users x
        n_items/8 bytes) or ``"lists"`` (padded sorted item lists,
        n_users x max_degree x 4 bytes). With a ``mesh`` the server lives
        on the mesh's device and ``device`` is not read."""
        super().__init__()
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a topk_rec_torch.parallel.Mesh, "
                            f"got {type(mesh).__name__}")
        if seen_format not in ("bitmap", "lists"):
            raise ValueError(f"unknown seen_format {seen_format!r}")
        self.mesh = mesh
        dev = mesh.device if mesh is not None else resolve_device(device)
        dt = torch.float32 if table_dtype is None else table_dtype

        def table(a, dtype):
            # a copy: the buffers never alias the caller's arrays
            if not isinstance(a, torch.Tensor):
                a = torch.tensor(np.asarray(a, dtype=np.float32))
            else:
                a = a.clone()
            return a.to(device=dev, dtype=dtype).contiguous()

        self.n_users = U.shape[0]
        self.register_buffer("U", self._shard(table(U, dt), 0.0))
        self.register_buffer("V", table(V, dt))
        self.register_buffer(
            "bias",
            None if bias is None else table(bias, torch.float32).reshape(-1),
        )
        # On the card, the kernel methods read U and V as K1 and K2 take
        # them in the serving mode (bf16, rows zero-padded to 16 columns):
        # copies, so that no served batch casts or pads the catalog. They
        # are made here and remade by ``_kernel_tables`` when U or V changed
        # since (``load_state_dict``, an in-place edit, ``to``). On the CPU
        # the kernels' plain twins read U and V.
        self._kernel_key = None
        self._lookup_capacity = None  # the mesh lookup's, sticky
        for name in ("U", "V"):
            self.register_buffer(name + "_kernel", None, persistent=False)
        self.n_items = self.V.shape[0]
        self.seen_format = seen_format
        n_users = self.n_users
        n_words = (self.n_items + 31) // 32
        if exclude_seen and interactions is not None:
            if seen_format == "lists":
                indptr, flat = interactions.user_csr
                deg = np.diff(indptr)
                D = max(1, int(deg.max()))
                lists = np.full((n_users, D), self.n_items, np.int32)
                rows = np.repeat(np.arange(len(deg)), deg)
                cols = np.arange(len(flat)) - np.repeat(indptr[:-1], deg)
                lists[rows, cols] = flat
                seen = torch.from_numpy(lists).to(dev)
            else:
                seen = bitmap_tensor(interactions.seen_bitmap, dev)
        elif seen_format == "lists":
            seen = torch.full((n_users, 1), self.n_items, dtype=torch.int32,
                              device=dev)
        else:
            seen = torch.zeros((n_users, n_words), dtype=torch.int32,
                               device=dev)
        self.register_buffer(
            "seen",
            self._shard(seen, self.n_items if seen_format == "lists" else 0))
        if dev.type == "cuda":
            self._make_kernel_tables()

    def _shard(self, t: torch.Tensor, pad_value) -> torch.Tensor:
        """``t`` itself without a mesh; with one, this rank's block of its
        rows over "mp", the rows padded with ``pad_value`` to a multiple of
        the axis (no request reads a padded row)."""
        if self.mesh is None:
            return t
        n = self.mesh.shape["mp"]
        per = -(-t.shape[0] // n)
        at = self.mesh.coords["mp"] * per
        block = t[at:at + per]
        pad = per - block.shape[0]
        if pad:
            block = torch.cat([block, block.new_full((pad, *t.shape[1:]),
                                                     pad_value)])
        return block.clone()

    def _table_key(self):
        """What identifies the contents of U and V without reading them:
        each table's version counter (bumped by every in-place write),
        storage, shape and type."""
        return tuple((t._version, t.data_ptr(), tuple(t.shape), t.dtype)
                     for t in (self.U, self.V))

    def _make_kernel_tables(self):
        # kernel_table returns a table already in kernel form (bf16, d a
        # multiple of 16) itself: then the "copy" is the table
        self.U_kernel = kernel_table(self.U, exact_matmul=False)
        self.V_kernel = kernel_table(self.V, exact_matmul=False)
        self._kernel_key = self._table_key()

    def _kernel_tables(self):
        """(U, V) as the kernel methods read them: the kernel copies,
        remade first if U or V changed since they were made (no host sync,
        and no launch when nothing changed); U and V themselves where no
        copies are held."""
        if self.V_kernel is None:
            return self.U, self.V
        if self._table_key() != self._kernel_key:
            self._make_kernel_tables()
        return self.U_kernel, self.V_kernel

    @classmethod
    def from_model(cls, model, exclude_seen: bool = True,
                   device="cuda", table_dtype=None) -> "TopKServer":
        """Serve a trained JAX-package model (``fue``/``fie``/``fib``)."""
        from .interop import from_jax_params

        U, V, bias = from_jax_params(model, device, table_dtype)
        return cls(U, V, bias, model.inter, exclude_seen,
                   table_dtype=table_dtype, device=device)

    def recommend_async(
        self,
        user_ids,
        k: int = 30,
        method: str = "exact",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Queue a query batch; returns device tensors (serving.py:212-273).

        Every method but ``hybrid`` returns without synchronizing. The
        ``hybrid`` method makes one host sync, to find the rows that fail
        its audit (JAX keeps that loop on the device)."""
        with span("serve.submit"):
            uid = torch.as_tensor(np.asarray(user_ids, dtype=np.int64)).to(
                self.U.device
            )
            U, V = self.U, self.V
            if method in ("kernel", "hybrid"):
                U, V = self._kernel_tables()
            if self.mesh is not None:
                return self._query_mesh(U, V, uid, k, method)
            return _query_local(
                U, V, self.bias, self.seen, uid, k, method, self.n_items,
                self.seen_format,
            )

    def _query_mesh(self, U, V, uid, k, method):
        """The sharded query (serving.py:225-259): the batch padded to a
        multiple of "mp", this rank's slice looked up and ranked, the
        slices all-gathered (padded rows included: callers slice to the
        request length).

        Overflow costs no host sync on the common path: when any rank's
        lookup dropped a row, the values come back NaN on every rank, and
        ``recommend`` grows the capacity and asks again."""
        mesh = self.mesh
        n_shards = mesh.shape["mp"]
        uid = torch.cat([uid, uid.new_zeros((-uid.shape[0]) % n_shards)])
        b_local = uid.shape[0] // n_shards
        if self._lookup_capacity is None:
            self._lookup_capacity = default_capacity(b_local, n_shards)
        self._cap_limit = b_local
        cap = min(self._lookup_capacity, b_local)
        u_rows, ovf_u = sharded_lookup(U, uid, mesh, capacity=cap)
        s_rows, ovf_s = sharded_lookup(self.seen, uid, mesh, capacity=cap)
        vals, idx = _query(u_rows, V, self.bias, s_rows, k, method,
                           self.n_items, self.seen_format)
        overflowed = (ovf_u.sum() + ovf_s.sum()) > 0
        vals = torch.where(overflowed, torch.nan, vals)
        group = mesh.groups["mp"]
        return all_gather_rows(vals, group), all_gather_rows(idx, group)

    def recommend(
        self,
        user_ids,
        k: int = 30,
        method: str = "exact",
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k unseen items for a batch of users: numpy (scores [B, k],
        item ids [B, k]); score -inf means fewer than k unseen items.

        With a mesh, a batch whose lookup overflowed is asked again with
        twice the sticky capacity (serving.py:185-210); a capacity of the
        local batch cannot overflow, so the loop ends. Every rank reads the
        same gathered values, so all ranks retry together."""
        n = len(user_ids)
        with span("serve.recommend"):
            while True:
                vals, idx = self.recommend_async(user_ids, k, method)
                with span("serve.fetch"):
                    v = vals.cpu().numpy()[:n]
                    ids = idx.cpu().numpy()[:n]
                if self.mesh is None or not np.isnan(v).any():
                    return v, ids
                cap = self._lookup_capacity
                if cap >= self._cap_limit:  # the NaN came from the data
                    return v, ids
                self._lookup_capacity = min(2 * cap, self._cap_limit)
