"""Batched weighted-ALS half-sweeps (counterpart of
``topk_rec_tpu/ops/als.py``).

With confidence weights a (positive) and b (background), entity t with
positive set I_t over the fixed side V solves (als.py:8-25)

    A_t = b·Vᵣᵀ Vᵣ + (a-b)·Σ_{j∈I_t} v_j v_jᵀ + λ·I
    A_t x_t = a·Σ_{j∈I_t} v_j  (+ λ·prior_t for the content models)

over the same blocks as JAX: :class:`ALSPlan` deals the entities into
degree-balanced round-robin blocks of ``block_size`` slots, with the
entity of each slot in ``perm`` (``n_this`` marks an empty slot) and each
block's (row, col) positive pairs padded to ``cap`` with (``block_size``,
0).

What differs, on purpose:

* The sums Σ v vᵀ and Σ v are taken over the pairs, not through JAX's dense
  0/1 selection matrix S [block_size, n_other] (a TPU device for the MXU):
  each block's pairs are a CSR matrix with one row per slot and one extra
  row that takes the padding pairs, and one sparse-dense product
  ``S @ [VV ‖ V]`` (VV = [v vᵀ] per row of the fixed side) gives both sums.
  The padding row is dropped, as JAX drops row ``block_size``. Only the
  order of the fp32 sums differs from JAX.
* :func:`batched_solve` factors with ``torch.linalg.cholesky_ex`` and
  ``torch.cholesky_solve`` after JAX's 1e-6·trace/k jitter. A system whose
  factorization fails (a non-positive pivot, which JAX's looped Cholesky
  clamps to 1e-10·trace/k instead) is solved again by
  :func:`looped_cholesky_solve`, a transcription of that loop, so those
  rank-1-dominant systems stay finite as in JAX.

Every product is true fp32 (``resolve_device`` turns TF32 off): JAX
assembles at ``Precision.HIGH`` because bf16-rounded assembly sent the
content models to NaN (als.py:37-42).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from ..tracing import span

Tensorish = Union[np.ndarray, torch.Tensor]


def gram_matrix(emb: torch.Tensor,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eᵣᵀ Eᵣ over the selected rows (als.py:45-49)."""
    sel = emb[rows] if rows is not None else emb
    return sel.T @ sel


def _jitter(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A + 1e-6·(trace/k)·I and the scale trace/k [..., 1, 1] (als.py:77-81)."""
    k = A.shape[-1]
    scale = (torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / k)[..., None, None]
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    return A + 1e-6 * scale * eye, scale


def looped_cholesky_solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """JAX's ``batched_solve`` (als.py:52-125) as plain PyTorch: the same
    jitter, a column-by-column Cholesky whose pivots are clamped to
    1e-10·trace/k, then forward and back substitution. ``A`` [..., k, k],
    ``rhs`` [..., k] or [..., k, m]."""
    squeeze = rhs.dim() == A.dim() - 1
    if squeeze:
        rhs = rhs.unsqueeze(-1)
    k = A.shape[-1]
    A, scale = _jitter(A)
    floor = 1e-10 * scale
    row = torch.arange(k, device=A.device)
    L = torch.zeros_like(A)
    for j in range(k):
        d = torch.sqrt(torch.maximum(A[..., j:j + 1, j:j + 1], floor))
        col = torch.where((row >= j)[:, None], A[..., :, j:j + 1] / d, 0.0)
        L[..., :, j:j + 1] = col
        A = A - col * col.transpose(-1, -2)
    y = torch.zeros_like(rhs)
    for j in range(k):
        lrow = L[..., j:j + 1, :]
        y[..., j:j + 1, :] = (rhs[..., j:j + 1, :] - lrow @ y) / lrow[..., j:j + 1]
    Lt = L.transpose(-1, -2)
    x = torch.zeros_like(rhs)
    for j in range(k - 1, -1, -1):
        lrow = Lt[..., j:j + 1, :]
        x[..., j:j + 1, :] = (y[..., j:j + 1, :] - lrow @ x) / lrow[..., j:j + 1]
    return x.squeeze(-1) if squeeze else x


def batched_solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve A_t x_t = rhs_t for a batch of SPD k×k systems.

    ``A`` [B, k, k], ``rhs`` [B, k] or [B, k, m]. One host sync (the span
    ``als.sync``) reads whether any factorization failed; those systems
    are solved again by :func:`looped_cholesky_solve`.
    """
    squeeze = rhs.dim() == A.dim() - 1
    if squeeze:
        rhs = rhs.unsqueeze(-1)
    L, info = torch.linalg.cholesky_ex(_jitter(A)[0])
    x = torch.cholesky_solve(rhs, L)
    with span("als.sync"):
        bad = info.nonzero().squeeze(1)
    if bad.numel():
        x[bad] = looped_cholesky_solve(A[bad], rhs[bad])
    return x.squeeze(-1) if squeeze else x


class ALSPlan:
    """The static block layout of one side of the alternation (als.py:128-
    206): the same NumPy construction as JAX, with the stacks on
    ``device``, the card unless the caller asks for the CPU.

    Attributes: ``n_this``, ``block_size``, ``n_blocks``, ``cap``,
    ``rows_stack`` / ``cols_stack`` [n_blocks, cap], ``deg_stack``
    [n_blocks, block_size], ``perm`` [n_blocks·block_size] (all int64), and
    ``selection``: per block the CSR pair matrix [block_size + 1, n_other]
    whose last row holds the padding pairs (built by :meth:`selection_for`
    for the fixed side's row count on first use).
    """

    def __init__(
        self,
        indptr: np.ndarray,
        flat: np.ndarray,
        n_this: int,
        block_size: int = 2048,
        balanced: bool = True,
        device="cuda",
    ):
        self.n_this = n_this
        self.block_size = block_size
        self.device = resolve_device(device)
        deg = np.diff(indptr).astype(np.int64)
        n_blocks = max(1, -(-n_this // block_size))
        self.n_blocks = n_blocks
        if balanced and n_blocks > 1:
            order = np.argsort(-deg, kind="stable")
        else:
            order = np.arange(n_this)
        # deal entities into blocks round-robin over the chosen order
        per_block = [order[b::n_blocks] for b in range(n_blocks)]
        perm = np.full(n_blocks * block_size, n_this, dtype=np.int64)
        self.cap = max([1] + [int(deg[ents].sum()) for ents in per_block])
        rows_l, cols_l, deg_l = [], [], []
        for b, ents in enumerate(per_block):
            perm[b * block_size:b * block_size + len(ents)] = ents
            lens = deg[ents]
            rows = np.repeat(np.arange(len(ents), dtype=np.int64), lens)
            starts = indptr[ents].astype(np.int64)
            total = int(lens.sum())
            offs = np.arange(total, dtype=np.int64) - np.repeat(
                np.cumsum(lens) - lens, lens)
            cols = flat[np.repeat(starts, lens) + offs].astype(np.int64)
            pad = self.cap - total
            rows_l.append(np.pad(rows, (0, pad), constant_values=block_size))
            cols_l.append(np.pad(cols, (0, pad), constant_values=0))
            deg_block = np.zeros(block_size, dtype=np.int64)
            deg_block[:len(ents)] = lens
            deg_l.append(deg_block)

        def dev(a):
            return torch.from_numpy(np.stack(a) if isinstance(a, list)
                                    else a).to(self.device)

        self.rows_stack = dev(rows_l)
        self.cols_stack = dev(cols_l)
        self.deg_stack = dev(deg_l)
        self.perm = dev(perm)
        self._selection: Optional[List[torch.Tensor]] = None
        self._n_other = -1

    def selection_for(self, n_other: int) -> List[torch.Tensor]:
        """The per-block CSR pair matrices for a fixed side of ``n_other``
        rows: slot s's pairs in row s (rows are sorted within a block), the
        padding pairs in row ``block_size``, values 1."""
        if self._n_other != n_other:
            zero = torch.zeros(1, dtype=torch.int64, device=self.device)
            cap = torch.full((1,), self.cap, dtype=torch.int64,
                             device=self.device)
            ones = torch.ones(self.cap, device=self.device)
            with warnings.catch_warnings():  # "CSR support is in beta"
                warnings.simplefilter("ignore", UserWarning)
                self._selection = [
                    torch.sparse_csr_tensor(
                        torch.cat([zero, deg.cumsum(0), cap]), cols, ones,
                        size=(self.block_size + 1, n_other),
                        check_invariants=False)
                    for deg, cols in zip(self.deg_stack, self.cols_stack)
                ]
            self._n_other = n_other
        return self._selection

    def slot_selection(self, n_other: int, lo: int,
                       hi: int) -> List[torch.Tensor]:
        """As :meth:`selection_for`, for the slots [lo, hi) of every block
        only: per block the CSR pair matrix [hi - lo, n_other], without a
        padding row. Built from one host read of the degrees."""
        deg = self.deg_stack.cpu().numpy()
        offs = np.concatenate([np.zeros((self.n_blocks, 1), np.int64),
                               np.cumsum(deg, axis=1)], axis=1)
        out = []
        with warnings.catch_warnings():  # "CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            for blk in range(self.n_blocks):
                c0, c1 = int(offs[blk, lo]), int(offs[blk, hi])
                crow = torch.from_numpy(offs[blk, lo:hi + 1] - c0).to(
                    self.device)
                out.append(torch.sparse_csr_tensor(
                    crow, self.cols_stack[blk, c0:c1],
                    torch.ones(c1 - c0, device=self.device),
                    size=(hi - lo, n_other), check_invariants=False))
        return out


def to_slots(plan: ALSPlan, t: torch.Tensor) -> torch.Tensor:
    """Entity rows [n_this, k] -> block slots [n_blocks, block_size, k]; an
    empty slot (perm == n_this) reads a zero row, as JAX's
    ``.at[perm].get(mode="fill")``."""
    k = t.shape[1]
    return torch.cat([t, t.new_zeros(1, k)])[plan.perm].view(
        plan.n_blocks, plan.block_size, k)


def from_slots(plan: ALSPlan, stack: torch.Tensor) -> torch.Tensor:
    """Block slots -> entity order; empty slots land in row n_this, which is
    dropped."""
    k = stack.shape[-1]
    out = stack.new_zeros(plan.n_this + 1, k)
    out[plan.perm] = stack.reshape(-1, k)
    return out[:plan.n_this]


def solve_slots(
    selection: List[torch.Tensor],  # per block, the pairs of the slots
    deg_stack: torch.Tensor,   # [n_blocks, s] the slots' degrees
    old_stack: torch.Tensor,   # [n_blocks, s, k] the slots' current rows
    prior_stack: Optional[torch.Tensor],  # [n_blocks, s, k] or None
    other_emb: torch.Tensor,   # [n_other, k]
    rated_mask: torch.Tensor,  # float32 [n_other], 1 for rated rows
    a: float,
    b: float,
    lam: float,
    keep_old_unrated: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve ``s`` slots of every block (the block loop of ``_sweep_impl``,
    als.py:209-311); returns (new rows [n_blocks, s, k], their fit as a 0-d
    tensor)."""
    n_other, k = other_emb.shape
    s = deg_stack.shape[1]
    # [v vᵀ ‖ v] per fixed row: one sparse product gives both sums
    vvx = torch.cat([(other_emb[:, :, None] * other_emb[:, None, :])
                     .reshape(n_other, k * k), other_emb], 1)
    sel = other_emb * rated_mask[:, None]
    gram_b = b * gram_matrix(sel)
    eye = lam * torch.eye(k, dtype=torch.float32, device=other_emb.device)
    new_stack = torch.empty_like(old_stack)
    fits = []
    for blk, S in enumerate(selection):
        sums = (S @ vvx)[:s]
        P, sum_v = sums[:, :k * k].view(s, k, k), sums[:, k * k:]
        A_fit = gram_b + (a - b) * P
        rhs = a * sum_v
        if prior_stack is not None:
            rhs = rhs + lam * prior_stack[blk]
        new = batched_solve(A_fit + eye, rhs)
        deg = deg_stack[blk]
        if keep_old_unrated:
            new = torch.where((deg > 0)[:, None], new, old_stack[blk])
        new_stack[blk] = new
        quad = 0.5 * torch.einsum("bi,bij,bj->b", new, A_fit, new)
        lin = a * (sum_v * new).sum(1)
        fits.append(torch.where(deg > 0, 0.5 * deg * a + quad - lin,
                                0.0).sum())
    return new_stack, torch.stack(fits).sum()


def _sweep(
    plan: ALSPlan,
    this_emb: torch.Tensor,    # [n_this, k]
    other_emb: torch.Tensor,   # [n_other, k]
    rated_mask: torch.Tensor,  # float32 [n_other], 1 for rated rows
    prior: Optional[torch.Tensor],  # [n_this, k] or None
    a: float,
    b: float,
    lam: float,
    keep_old_unrated: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One half-sweep over the plan's blocks (``_sweep_impl``, als.py:209-
    311); returns (new [n_this, k], fit as a 0-d tensor)."""
    new_stack, fit = solve_slots(
        plan.selection_for(other_emb.shape[0]), plan.deg_stack,
        to_slots(plan, this_emb),
        to_slots(plan, prior) if prior is not None else None, other_emb,
        rated_mask, a, b, lam, keep_old_unrated)
    return from_slots(plan, new_stack), fit


def rated_mask_of(n_other: int, rated_other, device) -> torch.Tensor:
    """float32 [n_other]: 1 at the rated rows of the fixed side."""
    mask = torch.zeros(n_other, device=device)
    mask[torch.as_tensor(rated_other).to(device).long()] = 1.0
    return mask


def half_sweep(
    plan: ALSPlan,
    this_emb: Tensorish,
    other_emb: Tensorish,
    rated_other: Tensorish,
    a: float,
    b: float,
    lam: float,
    prior: Optional[Tensorish] = None,
    keep_old_unrated: bool = True,
    as_numpy: bool = True,
):
    """One ALS half-sweep: update ``this_emb`` given fixed ``other_emb``
    (als.py:360-420), on the plan's device.

    Returns (updated embeddings, fit-loss contribution of the rated
    entities). With a ``prior`` the right-hand side gains λ·prior and the
    unrated entities are solved from the prior alone; without one they keep
    their rows when ``keep_old_unrated``. ``as_numpy=False`` returns a
    tensor and a 0-d tensor on the device (no host sync).
    """
    dev = plan.device

    def on_dev(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dev)

    other = on_dev(other_emb)
    rated_mask = rated_mask_of(other.shape[0], rated_other, dev)
    use_prior = prior is not None
    new, fit = _sweep(plan, on_dev(this_emb), other, rated_mask,
                      on_dev(prior) if use_prior else None, float(a),
                      float(b), float(lam), keep_old_unrated and not use_prior)
    if not as_numpy:
        return new, fit
    return new.cpu().numpy(), float(fit)


def weighted_als_user_update(
    user_emb: np.ndarray,
    item_emb: np.ndarray,
    inter,
    a: float,
    b: float,
    lam_u: float,
    block_size: int = 2048,
    device="cuda",
) -> np.ndarray:
    """One-shot user-side update (tests and simple callers, als.py:423-
    444), on ``device``."""
    indptr, flat = inter.user_csr
    plan = ALSPlan(indptr, flat, inter.n_users, block_size, device=device)
    new, _ = half_sweep(plan, user_emb, item_emb, inter.rated_items, a, b,
                        lam_u)
    return new
