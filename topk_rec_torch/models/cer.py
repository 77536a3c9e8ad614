"""CER: collaborative embedding regression, WMF with a linear content prior
(counterpart of ``topk_rec_tpu/models/cer.py``).

Item factors are pulled towards F·E, the features F [n_items, d] times a
content projection E [d, k] that is refitted each iteration by ridge
regression, E = (lv·FᵀF + le·I)⁻¹·lv·Fᵀ·V, and items nobody rated take
F·E as their factors after training (reference cer.py:24-73). Defaults
mirror reference cer.py:17: lu = 0.01, lv = 10, le = 1e4, a = 1, b = 0.01.

The E-solve takes JAX's routes (cer.py:159-207):

* d ≤ n_items: the d×d system directly (``torch.linalg.solve``);
* d > n_items: the Woodbury form E = lv·Fᵀ·(le·I + lv·F·Fᵀ)⁻¹·V, an
  n_items×n_items system, by conjugate gradients on the cached G = F·Fᵀ.
  JAX's ``while_loop`` exit becomes a host check of max(rs/ys) > tol² before
  each CG step (one sync per step, at most ``e_solver_iters``), so the port
  takes as many steps as JAX. A worst relative residual above
  ``e_solver_fallback_tol`` (or NaN) warns and solves the n×n system
  directly, for this feature set from then on.

F stays on the device for the whole ``train`` and is released afterwards,
with G (about 1.2 GB at d = 20000 on the MovieLens catalog). Every product
is true fp32, as JAX's ``HIGHEST``.

Spans (``tracing.py``): ``cer.features`` (F's upload), ``cer.iter`` (one
iteration), ``cer.esolve`` (the E-solve) holding ``cer.gram`` (G, in the
first), ``cer.cg_step`` (a CG step with the check after it) and
``cer.esolve_direct`` (a direct Woodbury solve), ``cer.loss`` (the loss
read) and ``cer.writeback`` (the tables' read and the cold-start
write-back); the half-sweeps are ``WMF._sweeps``' ``als.half_sweep``.
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


def _ridge_woodbury_cg(
    F: torch.Tensor, G: torch.Tensor, Y: torch.Tensor, lv: float, le: float,
    iters: int, tol: float = 1e-6,
) -> Tuple[torch.Tensor, float, int]:
    """E = lv·Fᵀ·(le·I_n + lv·G)⁻¹·Y by conjugate gradients, one column of
    Y per system (cer.py:48-100).

    Returns (E, rel, steps): rel is the worst column's final
    ‖residual‖/‖y‖ and steps the CG steps taken.
    """
    def matvec(X):
        return le * X + lv * (G @ X)

    X = torch.zeros_like(Y)
    R = Y - matvec(X)
    P = R
    rs = (R * R).sum(0)
    ys = torch.clamp((Y * Y).sum(0), min=1e-30)
    steps = 0
    more = iters > 0 and float((rs / ys).max()) > tol * tol
    while more:
        # a step and the host check that decides the next one
        with span("cer.cg_step"):
            AP = matvec(P)
            alpha = rs / torch.clamp((P * AP).sum(0), min=1e-30)
            X = X + alpha[None, :] * P
            R = R - alpha[None, :] * AP
            rs_new = (R * R).sum(0)
            beta = rs_new / torch.clamp(rs, min=1e-30)
            P = R + beta[None, :] * P
            rs = rs_new
            steps += 1
            more = steps < iters and float((rs / ys).max()) > tol * tol
    rel = float(torch.sqrt((rs / ys).max()))
    return lv * (F.T @ X), rel, steps


def _ridge_woodbury_direct(F: torch.Tensor, G: torch.Tensor, Y: torch.Tensor,
                           lv: float, le: float) -> torch.Tensor:
    """The Woodbury form solved directly (cer.py:103-115): the fallback
    when CG does not converge."""
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
        self._gram_items: Optional[torch.Tensor] = None  # F·Fᵀ (Woodbury)
        self.e_solver_iters = 60
        # CG exit threshold, and the bar above which the E-solve warns and
        # solves directly
        self.e_solver_tol = 1e-6
        self.e_solver_fallback_tol = 1e-3
        self.e_solver_steps = 0  # CG steps of the last E-solve
        self._e_solver_use_direct = False

    def set_features(self, feat: np.ndarray) -> None:
        super().set_features(feat)
        self._feat_dev = None
        self._gram_items = None
        self._e_solver_use_direct = False  # new F: give CG a fresh shot

    def _feat_device(self) -> torch.Tensor:
        if self._feat_dev is None:
            with span("cer.features"):
                self._feat_dev = torch.from_numpy(self.feat).to(self.device)
        return self._feat_dev

    def _solve_E(self, Y: torch.Tensor) -> torch.Tensor:
        with span("cer.esolve"):
            F = self._feat_device()
            self.e_solver_steps = 0
            if self.d <= self.n_items:
                return _ridge_direct(F, Y, self.lv, self.le)
            if self._gram_items is None:
                with span("cer.gram"):
                    self._gram_items = F @ F.T
            G = self._gram_items
            # once CG has failed for this (le, lv, F), it fails every
            # iteration
            if self._e_solver_use_direct:
                return _ridge_woodbury_direct(F, G, Y, self.lv, self.le)
            E, rel, self.e_solver_steps = _ridge_woodbury_cg(
                F, G, Y, self.lv, self.le, self.e_solver_iters,
                tol=self.e_solver_tol)
            # NaN-safe: `NaN <= tol` is False, so a diverged CG falls back too
            if not (rel <= self.e_solver_fallback_tol):
                warnings.warn(
                    f"CER E-solve: Woodbury-CG did not converge in "
                    f"{self.e_solver_iters} iterations (relative residual "
                    f"{rel:.2e} > {self.e_solver_fallback_tol:.0e}; "
                    f"le={self.le:g} may be too small for the CG budget) — "
                    f"falling back to the exact direct solve (slower) for "
                    f"the rest of this feature set. To retry the fast path "
                    f"after raising model.e_solver_iters, call set_features "
                    f"again (it resets the verdict).",
                    RuntimeWarning, stacklevel=2)
                self._e_solver_use_direct = True
                return _ridge_woodbury_direct(F, G, Y, self.lv, self.le)
            return E

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
