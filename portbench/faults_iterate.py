"""Faults planted in CER's timed path (``CER.train``), for the readings the
``iterate`` kind's limits are set from, and for tests.

Each fault is a context manager that patches one function of
``topk_rec_torch`` and restores it on exit; a model built inside it runs
with the fault from its first call:

* ``cg_half_steps``: each Woodbury-CG E-solve stops at half the steps it
  takes (the solve is run once to count them, then again with half as its
  budget), and then falls back as the program does when it has not
  converged;
* ``item_no_prior``: the item half-sweep runs without its prior F·E;
* ``e_unchanged``: the second E-solve of the model's life, the second
  iteration of its first call, returns E unchanged.
"""

from __future__ import annotations

import contextlib
from typing import Dict

from portbench.faults import patched


@contextlib.contextmanager
def cg_half_steps():
    import topk_rec_torch.models.cer as cer

    def wrap(old):
        def solve(F, G, Y, lv, le, iters, tol=1e-6):
            _, _, steps = old(F, G, Y, lv, le, iters, tol=tol)
            return old(F, G, Y, lv, le, max(1, steps // 2), tol=tol)
        return solve

    with patched(cer, "_ridge_woodbury_cg", wrap):
        yield


@contextlib.contextmanager
def item_no_prior():
    from topk_rec_torch.models.wmf import WMF

    def wrap(old):
        def sweeps(self, prior=None):
            return old(self, prior=None)
        return sweeps

    with patched(WMF, "_sweeps", wrap):
        yield


@contextlib.contextmanager
def e_unchanged():
    from topk_rec_torch.models.cer import CER

    solves = [0]

    def wrap(old):
        def solve(self, Y):
            solves[0] += 1
            if solves[0] == 2:
                return self.tables.E
            return old(self, Y)
        return solve

    with patched(CER, "_solve_E", wrap):
        yield


def faults() -> Dict[str, object]:
    """The faults of the ``iterate`` kind, by name."""
    return {"cg_half_steps": cg_half_steps, "item_no_prior": item_no_prior,
            "e_unchanged": e_unchanged}
