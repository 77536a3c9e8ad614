"""Mesh-distributed weighted-ALS half-sweeps (counterpart of
``topk_rec_tpu/parallel/als.py``).

Each block's k×k systems are independent, so every block's slots are split
over all ranks of the mesh: with W ranks and blocks of ``block_size``
slots, rank r solves the slots [r·s, (r+1)·s) of each block, s =
ceil(block_size / W) (the last ranks may hold fewer, or none). The fixed
side, its [v vᵀ ‖ v] rows and the Gram are replicated: each rank builds
them itself. The solved slots are padded to s rows and all-gathered, so
that every rank ends holding the whole result, and the fit is summed with
``all_reduce``.

``batched_solve`` reads on the host whether a factorization failed: each
rank decides that for its own slots, and no collective sits inside that
branch.
"""

from __future__ import annotations

import weakref
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.als import (
    ALSPlan,
    from_slots,
    rated_mask_of,
    solve_slots,
    to_slots,
)
from .distributed import all_gather_rows
from .mesh import Mesh


class DistributedALS:
    """Fused half-sweeps with every block's slots split over the mesh's
    ranks; a drop-in for ``ops.als.half_sweep`` (same signature and
    results), so that the ALS models route through it when given a mesh.
    The plans must live on the mesh's device."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        # per plan: {n_other: this rank's slot selection}
        self._selections = weakref.WeakKeyDictionary()

    def slot_range(self, plan: ALSPlan) -> Tuple[int, int, int]:
        """(lo, hi, s): this rank's slots [lo, hi) of each block, padded to
        s rows for the gather."""
        s = -(-plan.block_size // self.mesh.size)
        lo = min(self.mesh.rank * s, plan.block_size)
        return lo, min(lo + s, plan.block_size), s

    def _selection(self, plan: ALSPlan, n_other: int, lo: int, hi: int):
        per_plan = self._selections.setdefault(plan, {})
        if n_other not in per_plan:
            per_plan[n_other] = plan.slot_selection(n_other, lo, hi)
        return per_plan[n_other]

    def half_sweep(
        self,
        plan: ALSPlan,
        this_emb,
        other_emb,
        rated_other,
        a: float,
        b: float,
        lam: float,
        prior=None,
        keep_old_unrated: bool = True,
        as_numpy: bool = True,
    ):
        """Drop-in distributed ``ops.als.half_sweep`` (als.py:543-603).

        Every rank passes the same full ``this_emb``/``other_emb`` (and
        ``prior``) and gets the same full result; ``as_numpy=False`` keeps
        it on the device (a tensor and a 0-d fit tensor)."""
        dev = self.mesh.device
        if plan.device != dev:
            raise ValueError(f"the plan lives on {plan.device}, this rank's "
                             f"mesh device is {dev}")

        def on_dev(x):
            return torch.as_tensor(x, dtype=torch.float32).to(dev)

        other = on_dev(other_emb)
        this = on_dev(this_emb)
        k = other.shape[1]
        use_prior = prior is not None
        lo, hi, s = self.slot_range(plan)
        nb = plan.n_blocks
        mine = torch.zeros((nb, s, k), device=dev)
        fit = torch.zeros((), device=dev)
        if hi > lo:
            new, fit = solve_slots(
                self._selection(plan, other.shape[0], lo, hi),
                plan.deg_stack[:, lo:hi], to_slots(plan, this)[:, lo:hi],
                to_slots(plan, on_dev(prior))[:, lo:hi] if use_prior
                else None,
                other, rated_mask_of(other.shape[0], rated_other, dev),
                float(a), float(b), float(lam),
                keep_old_unrated and not use_prior)
            mine[:, :hi - lo] = new
        # [W·nb, s, k] in rank order -> [nb, W·s, k]: each block's slots
        gathered = all_gather_rows(mine, self.mesh.group).view(
            self.mesh.size, nb, s, k).transpose(0, 1).reshape(nb, -1, k)
        new = from_slots(plan, gathered[:, :plan.block_size].contiguous())
        dist.all_reduce(fit, group=self.mesh.group)
        if not as_numpy:
            return new, fit
        return np.array(new.cpu().numpy()), float(fit)
