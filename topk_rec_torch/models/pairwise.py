"""The pairwise trainers' shared loops, run by BPR (``models/bpr.py``,
both table layouts) and VBPR (``models/vbpr.py``).

A chunk has two halves, so that tests can hand both packages the same
triplets: :meth:`PairwiseRecommender.sample_chunk` draws them in one
sampler call (one host sync, ``ops/sampling.py``), and
:func:`run_planned_steps` runs the steps on them, each model's chunk
stated as tables and leaves. :meth:`PairwiseRecommender.train` is both
models' epoch loop.

Random streams: the init draws come from a generator of their own, and each
epoch from a generator derived from (seed, epoch), so a run resumed at an
epoch boundary repeats the uninterrupted run's stream (bpr.py:520-525).
They are not JAX's streams. On the card ``index_add_`` sums duplicates with
atomics, so two runs there may differ in the last bits; on the CPU a run is
reproducible.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..checkpoint import CheckpointManager
from ..ops.sampling import TripletSampler
from ..ops.sparse_update import plan_sparse_updates, planned_rows
from ..tracing import span
from ..utils import tprint
from .base import Recommender

INIT_STREAM = 2**31 - 1  # the init's stream, apart from every epoch's


def stream_generator(seed: int, stream: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from (seed, stream)."""
    state = np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


class Leaf(NamedTuple):
    """The occurrences ``first:stop`` of a step's rows that the loss reads,
    their first ``cols`` columns (None: all; the rest get a zero gradient)."""
    first: int
    stop: int
    cols: Optional[int] = None


class SparseTable(NamedTuple):
    """A table and its accumulator, updated at the [S, M] rows ``idx``,
    and the leaves the loss reads from those rows."""
    table: torch.Tensor
    acc: torch.Tensor
    idx: torch.Tensor
    leaves: Tuple[Leaf, ...]


def run_planned_steps(
    sparse: Sequence[SparseTable],
    dense: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    loss: Callable[..., torch.Tensor],
    loss_args: tuple,
    sparse_update: Callable,
    dense_update: Optional[Callable],
    lr: float,
    inputs: Optional[Callable[[int], Tuple[torch.Tensor, ...]]] = None,
) -> torch.Tensor:
    """Run ``S`` steps on the ``sparse`` tables and the ``dense``
    (parameter, accumulator) pairs, in place; returns the summed loss as a
    0-d tensor on the device (no host sync).

    Each table is planned once (``ops/sparse_update.py``). A step runs
    ``inputs(s)`` (its inputs without a gradient), gathers each table's
    unique rows and from them its leaves, takes ``loss(*leaves, *dense
    parameters, *inputs(s), *loss_args)`` and its gradients with one
    ``torch.autograd.grad``, sums each table's with ``index_add_``, calls
    ``sparse_update(table, acc, uniq, rows, acc_rows, agg, lr)`` on each
    table, then ``dense_update(param, acc, grad, lr)`` on each pair. The
    module that states a chunk passes its own loss and updates, as they
    stand when the chunk runs."""
    plans = [plan_sparse_updates(t.idx) for t in sparse]
    losses = []
    for s in range(sparse[0].idx.shape[0]):
        with span("train.step"):
            extra = () if inputs is None else inputs(s)
            # one gather of unique rows per table; the rows of each
            # occurrence come from those (bpr.py:256-268)
            gathered = [planned_rows(t.table, t.acc, uniq[s])
                        for t, (uniq, _) in zip(sparse, plans)]
            with torch.enable_grad():
                leaves = [
                    rows[seg[s, leaf.first:leaf.stop], :leaf.cols]
                    .requires_grad_()
                    for t, (rows, _), (_, seg) in zip(sparse, gathered, plans)
                    for leaf in t.leaves]
                params = [p.detach().requires_grad_() for p, _ in dense]
                with span("train.grad"):
                    out = loss(*leaves, *params, *extra, *loss_args)
                    grads = torch.autograd.grad(out, (*leaves, *params))
            at = 0
            for t, (uniq, seg), (rows, acc_rows) in zip(sparse, plans,
                                                        gathered):
                gs = [g if leaf.cols is None
                      else F.pad(g, (0, rows.shape[1] - leaf.cols))
                      for leaf, g in zip(t.leaves, grads[at:])]
                at += len(t.leaves)
                agg = torch.zeros_like(rows).index_add_(
                    0, seg[s], gs[0] if len(gs) == 1 else torch.cat(gs))
                sparse_update(t.table, t.acc, uniq[s], rows, acc_rows, agg,
                              lr)
            for (p, m), g in zip(dense, grads[at:]):
                dense_update(p, m, g, lr)
            losses.append(out.detach())
    return torch.stack(losses).sum()


class PairwiseRecommender(Recommender):
    """Base of BPR and VBPR: the checks of ``mode`` and ``membership``, the
    device sampler, a chunk's triplets and the epoch loop :meth:`train`.

    A model gives ``_init_params``, ``_sync_host``, ``train_chunk``,
    ``_print_header`` and ``SCAN_STEPS`` (a chunk's steps when ``train`` is
    not told); it may add to ``train_chunk``'s arguments
    (:meth:`_chunk_args`), check its own data (:meth:`_check_data`) and
    free what only training needed (:meth:`_release`)."""

    def __init__(self, k: int, lambda_u: float, lambda_i: float,
                 lambda_j: float, lambda_b: float, lr: float, mode: str,
                 seed: int, k_candidates: int, membership: str, device):
        super().__init__(k, device)
        if mode not in ("l2", "l1"):
            raise ValueError(f"mode must be l2|l1, got {mode!r}")
        if membership not in ("auto", "bitmap", "sorted"):
            raise ValueError(
                f"membership must be auto|bitmap|sorted, got {membership!r}")
        self.lu, self.li, self.lj, self.lb = (lambda_u, lambda_i, lambda_j,
                                              lambda_b)
        self.lr = lr
        self.mode = mode
        self.seed = seed
        self.k_candidates = k_candidates
        self.membership = membership
        self.sampler: Optional[TripletSampler] = None
        self.tables: Optional[nn.Module] = None

    def hyper(self) -> Dict[str, float]:
        return {"lu": self.lu, "li": self.li, "lj": self.lj, "lb": self.lb,
                "lr": self.lr}

    def _on_data_loaded(self) -> None:
        self.sampler = TripletSampler(self.inter, self.k_candidates,
                                      membership=self.membership,
                                      device=self.device)

    def sample_chunk(self, gen: torch.Generator, n_steps: int,
                     batch_size: int) -> Tuple[torch.Tensor, ...]:
        """(u, i, j), each [n_steps, batch_size], in one sampler call."""
        with span("train.sample"):
            trip = self.sampler(gen, n_steps * batch_size)
        return tuple(t.view(n_steps, batch_size) for t in trip)

    def _check_data(self) -> None:
        if self.inter is None:
            raise ValueError("no training data loaded")

    def _chunk_args(self, batch_size: int) -> tuple:
        """What ``train_chunk`` takes after the batch size."""
        return ()

    def _release(self) -> None:
        """Free what only training needed on the device."""

    def train(
        self,
        epochs: int = 5,
        batch_size: int = 256,
        epoch_sample_limit: Optional[int] = None,
        model_path: Optional[str] = None,
        scan_steps: Optional[int] = None,
        verbose: bool = True,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 1,
    ) -> None:
        """Reference-parity training loop (bpr.py:436-559,
        vbpr.py:373-468): ``epoch_sample_limit // batch_size + 1`` batches
        an epoch (default limit: the positive pairs, ref bpr.py:113) in
        whole chunks of ``scan_steps`` (default ``SCAN_STEPS``, JAX's per
        model), warm start from ``model_path``, a checkpoint of tables and
        accumulators every ``ckpt_every`` epochs in ``ckpt_dir`` and a
        resume from the latest that reproduces the uninterrupted run, one
        host sync an epoch for the loss."""
        self._check_data()
        if scan_steps is None:
            scan_steps = self.SCAN_STEPS
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
        args = self._chunk_args(batch_size)
        if verbose:
            self._print_header(epochs, n_chunks * scan_steps, batch_size,
                               scan_steps, *args)
        for eid in range(start_epoch, epochs):
            t0 = time.time()
            gen = stream_generator(self.seed, eid, self.device)
            losses = [self.train_chunk(gen, scan_steps, batch_size, *args)
                      for _ in range(n_chunks)]
            total_loss = float(torch.stack(losses).sum())
            if verbose:
                tprint("Epoch %3d, loss %.4f, time %.3fs"
                       % (eid + 1, total_loss, time.time() - t0))
            if mgr is not None:
                mgr.save(eid + 1, {"params": self.tables.params(),
                                   "ms": self.tables.ms()})
        self._sync_host()
        self._release()
