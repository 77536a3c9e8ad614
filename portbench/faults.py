"""Faults planted in the program, for the checks' fault readings and tests.

Each fault is a context manager that patches one function of
``topk_rec_torch`` on the timed path and restores it on exit:

* ``state_unchanged``: from a chunk's second step on, the training step's
  RMSProp writes nothing, so each such step returns its state unchanged;
* ``half_batch``: a training step's loss (from the chunk's second step
  on), or a scoring call, takes the first half of its batch only (the
  training loss doubled: the mean over the rest), the other half's rows
  carry no gradient or repeat the first half's answers;
* ``altered_answer``: the answer is altered where it is produced: the
  sampler's first negative of a call is its positive; K1's first and last
  results of each row change places.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch


@contextlib.contextmanager
def patched(module, name, fn):
    old = getattr(module, name)
    setattr(module, name, fn(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def _loss_of(model: str):
    """(module, name) of the training step's loss function."""
    import topk_rec_torch.models.bpr as bpr
    import topk_rec_torch.models.vbpr as vbpr

    return (bpr, "_pairwise_loss") if model == "bpr" else (vbpr, "_vbpr_loss")


@contextlib.contextmanager
def state_unchanged(model: str):
    module, loss = _loss_of(model)
    steps = [0]

    def counting(old):
        def call(*a, **k):
            steps[0] += 1
            return old(*a, **k)
        return call

    def first_step_only(old):
        def call(*a, **k):
            if steps[0] <= 1:
                return old(*a, **k)
        return call

    updates = ["apply_planned_rmsprop"] + (
        ["_rms_dense"] if model == "vbpr" else [])
    with contextlib.ExitStack() as st:
        st.enter_context(patched(module, loss, counting))
        for name in updates:
            st.enter_context(patched(module, name, first_step_only))
        yield


def _half_rows(*rows):
    h = rows[0].shape[0] // 2
    return [r[:h] for r in rows]


@contextlib.contextmanager
def half_batch_train(model: str):
    module, loss = _loss_of(model)
    # the rows of the step: BPR's (pu, pit, pjt), VBPR's and its (ic, jc)
    at = (0, 1, 2) if model == "bpr" else (0, 1, 2, 5, 6)
    steps = [0]

    def wrap(old):
        def call(*a, **k):
            steps[0] += 1
            if steps[0] == 1:
                return old(*a, **k)
            a = list(a)
            for n, r in zip(at, _half_rows(*(a[n] for n in at))):
                a[n] = r
            return 2.0 * old(*a, **k)
        return call

    with patched(module, loss, wrap):
        yield


@contextlib.contextmanager
def altered_triplet():
    from topk_rec_torch.ops.sampling import TripletSampler

    def wrap(old):
        def call(self, *a, **k):
            u, i, j = old(self, *a, **k)
            j = j.clone()
            j[0] = i[0]
            return u, i, j
        return call
    with patched(TripletSampler, "__call__", wrap):
        yield


def _k1_wrapper(kind: str):
    def wrap(old):
        def k1(U, V, bias, bits, k, *a, **kw):
            if kind == "half":
                h = max(1, U.shape[0] // 2)
                vals, idx = old(U[:h], V, bias, bits[:h], k, *a, **kw)
                reps = -(-U.shape[0] // h)
                return (vals.repeat(reps, 1)[:U.shape[0]].contiguous(),
                        idx.repeat(reps, 1)[:U.shape[0]].contiguous())
            vals, idx = old(U, V, bias, bits, k, *a, **kw)
            perm = torch.arange(vals.shape[1], device=vals.device)
            perm[0], perm[-1] = vals.shape[1] - 1, 0
            return vals[:, perm].contiguous(), idx[:, perm].contiguous()
        return k1
    return wrap


@contextlib.contextmanager
def k1_fault(kind: str):
    """``kind`` "half" or "altered", at both of K1's callers."""
    import topk_rec_torch.eval.device as evd
    import topk_rec_torch.serving as serving

    with patched(serving, "fused_score_topk", _k1_wrapper(kind)), \
            patched(evd, "fused_score_topk", _k1_wrapper(kind)):
        yield


def faults(kind: str, model: str = "bpr") -> Dict[str, object]:
    """The faults a cell of traffic ``kind`` can have, by name."""
    if kind == "train":
        return {"state_unchanged": lambda: state_unchanged(model),
                "half_batch": lambda: half_batch_train(model),
                "altered_answer": altered_triplet}
    return {"half_batch": lambda: k1_fault("half"),
            "altered_answer": lambda: k1_fault("altered")}
