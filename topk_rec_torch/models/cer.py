"""CER: collaborative embedding regression, WMF with a linear content prior
(counterpart of ``topk_rec_tpu/models/cer.py``).

Item factors are pulled towards F·E, the features F [n_items, d] times a
content projection E [d, k] that is refitted each iteration by ridge
regression, E = (lv·FᵀF + le·I)⁻¹·lv·Fᵀ·V, and items nobody rated take
F·E as their factors after training (reference cer.py:24-73). Defaults
mirror reference cer.py:17: lu = 0.01, lv = 10, le = 1e4, a = 1, b = 0.01.

The E-solve takes two routes (JAX's are cer.py:159-207):

* d ≤ n_items: the d×d system directly (``torch.linalg.solve``);
* d > n_items: the Woodbury form E = lv·Fᵀ·(le·I + lv·F·Fᵀ)⁻¹·V, an
  n_items×n_items system whose matrix A = le·I + lv·F·Fᵀ is fixed within a
  ``train`` call. The first E-solve of a call forms A in the memory of
  G = F·Fᵀ and factors it, A = L·Lᵀ (one host read of the factor's
  ``info``); each E-solve is then two triangular solves on L and no host
  read. JAX solves the same system by conjugate gradients to a relative
  residual of 1e-6; the factor solves it exactly, up to float32 rounding.
  An explicit A⁻¹ made from L, one product an E-solve, is faster on the
  H100 but less exact: after 20 iterations at the MovieLens widths its V
  lay 1.2-2.2e-4 from a float64 run, the solves' within 4e-6.
  If A is not positive definite in float32 (``info`` > 0, e.g. le ≤ 0),
  the E-solve warns and solves A by LU from G instead, for this feature
  set from then on.

F stays on the device for the whole ``train`` and is released afterwards,
with L (about 0.43 GB on the MovieLens catalog; while it is made, A and L
take twice that). Every product, the factor and the solves are true fp32,
as JAX's ``HIGHEST``.

Spans (``tracing.py``): ``cer.features`` (F's upload), ``cer.iter`` (one
iteration), ``cer.esolve`` (the E-solve) holding ``cer.gram`` (G, in the
first) with ``cer.factor`` (A's Cholesky and the read of its ``info``)
inside it, and ``cer.esolve_direct`` (an LU solve of the Woodbury system),
``cer.loss`` (the loss read) and ``cer.writeback`` (the tables' read and
the cold-start write-back); the half-sweeps are ``WMF._sweeps``'
``als.half_sweep``.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.io import read_dat, write_dat
from ..tracing import span
from ..utils import tprint
from ..utils.statelog import StateLog
from .wmf import WMF


def _ridge_direct(F: torch.Tensor, Y: torch.Tensor, lv: float,
                  le: float) -> torch.Tensor:
    """E = (lv·FᵀF + le·I_d)⁻¹ · lv·Fᵀ·Y (cer.py:35-45)."""
    d = F.shape[1]
    FF = lv * (F.T @ F) + le * torch.eye(d, dtype=F.dtype, device=F.device)
    return torch.linalg.solve(FF, lv * (F.T @ Y))


def _woodbury_factor(G: torch.Tensor, lv: float,
                     le: float) -> Tuple[Optional[torch.Tensor], int]:
    """(L, 0): the lower Cholesky factor of A = le·I_n + lv·G. A is formed
    in G's memory and freed once L is made, so pass a G that nothing else
    holds. (None, info) when A is not positive definite in G's precision
    (info > 0: the order of the first leading minor that is not)."""
    A = G.mul_(lv)
    del G
    A.diagonal().add_(le)
    with span("cer.factor"):
        L, info = torch.linalg.cholesky_ex(A)
        info = int(info)
        return (L if info == 0 else None), info


def _ridge_woodbury_factored(F: torch.Tensor, L: torch.Tensor,
                             Y: torch.Tensor, lv: float) -> torch.Tensor:
    """E = lv·Fᵀ·(L·Lᵀ)⁻¹·Y: the Woodbury form on the factor of
    ``_woodbury_factor``, two triangular solves."""
    return lv * (F.T @ torch.cholesky_solve(Y, L))


def _ridge_woodbury_direct(F: torch.Tensor, G: torch.Tensor, Y: torch.Tensor,
                           lv: float, le: float) -> torch.Tensor:
    """The Woodbury form solved by LU (cer.py:103-115): the fallback when
    le·I + lv·G has no Cholesky factor."""
    with span("cer.esolve_direct"):
        n = G.shape[0]
        A = le * torch.eye(n, dtype=G.dtype, device=G.device) + lv * G
        return lv * (F.T @ torch.linalg.solve(A, Y))


class CER(WMF):
    def __init__(
        self,
        k: int,
        d: int,
        lu: float = 0.01,
        lv: float = 10.0,
        le: float = 10e3,
        a: float = 1.0,
        b: float = 0.01,
        seed: int = 0,
        block_size: int = 2048,
        device="cuda",
        mesh=None,
    ):
        super().__init__(k, lu, lv, a, b, seed, block_size, device=device,
                         mesh=mesh)
        self.d = d
        self.le = le
        self.E: Optional[np.ndarray] = None
        self._feat_dev: Optional[torch.Tensor] = None    # F on the device
        # the Woodbury route's matrix for the call: the Cholesky factor of
        # le·I + lv·F·Fᵀ, or F·Fᵀ itself once the factor has failed
        self._factor: Optional[torch.Tensor] = None
        self._gram_items: Optional[torch.Tensor] = None
        # CG steps of the last E-solve: 0, as no route iterates (kept, with
        # the verdict below, for readers of the E-solve such as portbench)
        self.e_solver_steps = 0
        self._e_solver_use_direct = False  # the factor failed for this F

    def set_features(self, feat: np.ndarray) -> None:
        super().set_features(feat)
        self._feat_dev = None
        self._factor = None
        self._gram_items = None
        self._e_solver_use_direct = False  # new F: factor it afresh

    def _feat_device(self) -> torch.Tensor:
        if self._feat_dev is None:
            with span("cer.features"):
                self._feat_dev = torch.from_numpy(self.feat).to(self.device)
        return self._feat_dev

    def _woodbury_system(self, F: torch.Tensor) -> None:
        """The first E-solve's work on the Woodbury route: G = F·Fᵀ, then
        the Cholesky factor of le·I + lv·G, or G kept for LU if the factor
        fails (warned once, and kept for this feature set)."""
        with span("cer.gram"):
            if self._e_solver_use_direct:
                self._gram_items = F @ F.T
                return
            # G is passed unheld: A takes its memory, and is freed once L
            # is made
            self._factor, info = _woodbury_factor(F @ F.T, self.lv, self.le)
            if info == 0:
                return
            warnings.warn(
                f"CER E-solve: le·I + lv·F·Fᵀ has no Cholesky factor in "
                f"float32 (its leading minor of order {info} is not "
                f"positive definite; le={self.le:g}, lv={self.lv:g}) — "
                f"solving it by LU instead (slower) for the rest of this "
                f"feature set. set_features resets the verdict.",
                RuntimeWarning, stacklevel=3)
            self._e_solver_use_direct = True
            self._gram_items = F @ F.T

    def _solve_E(self, Y: torch.Tensor) -> torch.Tensor:
        with span("cer.esolve"):
            F = self._feat_device()
            if self.d <= self.n_items:
                return _ridge_direct(F, Y, self.lv, self.le)
            if self._factor is None and self._gram_items is None:
                self._woodbury_system(F)
            if self._factor is not None:
                return _ridge_woodbury_factored(F, self._factor, Y, self.lv)
            return _ridge_woodbury_direct(F, self._gram_items, Y, self.lv,
                                          self.le)

    def train(
        self,
        max_iter: int = 200,
        tol: float = 1e-4,
        model_path: Optional[str] = None,
        verbose: bool = True,
        log_dir: Optional[str] = None,
        save_lag: Optional[int] = None,
        save_dir: Optional[str] = None,
    ) -> None:
        """ALS ⇄ ridge-E alternation, then the cold-start write-back
        (cer.py:209-308); ``save_lag``/``save_dir`` as in ``WMF.train``."""
        if self.inter is None or self.feat is None:
            raise ValueError("CER needs training data and features")
        if model_path is not None and os.path.isdir(model_path):
            self.import_embeddings(model_path)
        slog = StateLog(log_dir, {
            "model": "cer", "k": self.k, "d": self.d, "lu": self.lu,
            "lv": self.lv, "le": self.le, "a": self.a, "b": self.b,
            "max_iter": max_iter, "tol": tol,
        })
        if self.E is None:
            rng = np.random.default_rng(self.seed + 17)
            self.E = rng.standard_normal((self.d, self.k)).astype(np.float32)
        F = self._feat_device()
        t = self._device_tables(E=self.E)
        loss = np.exp(50)
        for it in range(max_iter):
            with span("cer.iter"):
                t1 = time.time()
                Fe = F @ t.E
                fit = self._sweeps(prior=Fe)
                t.E = self._solve_E(t.V)
                with span("cer.loss"):
                    loss_old = loss
                    loss = float(fit + self._loss_reg(Fe)
                                 + 0.5 * self.le * (t.E ** 2).sum())
                cond = abs(loss_old - loss) / loss_old
                slog.append(it, loss, cond)
                if save_lag and save_dir and it % save_lag == 0:
                    self._save_lag_dump(save_dir, it)
                if verbose:
                    tprint("Iter %3d, loss %.6f, time %.2fs"
                           % (it, loss, time.time() - t1))
                if cond < tol:
                    break
        with span("cer.writeback"):
            self._sync_host()
            self.E = t.E.cpu().numpy().copy()
            # cold-start write-back (ref cer.py:70-73)
            Fe = (F @ t.E).cpu().numpy()
            unrated = np.setdiff1d(np.arange(self.n_items),
                                   self.inter.rated_items)
            self.fie[unrated] = Fe[unrated]
        self._feat_dev = None
        self._factor = None
        self._gram_items = None

    # ---- model-specific interchange: final-E.dat (ref cer.py:75-85) ----

    def import_model(self, model_path: str) -> None:
        p = os.path.join(model_path, "final-E.dat")
        if os.path.exists(p):
            tprint(f"Loading content projection matrix from {p}")
            self.E = read_dat(p)

    def export_model(self, model_path: str) -> None:
        if os.path.exists(model_path) and self.E is not None:
            write_dat(os.path.join(model_path, "final-E.dat"), self.E)
