"""WMF: weighted implicit-feedback matrix factorization by batched ALS
(counterpart of ``topk_rec_tpu/models/wmf.py``).

The confidence-weighted squared loss with positive weight ``a``,
background weight ``b`` and L2 priors ``lu``/``lv``, solved by alternating
half-sweeps (``ops/als.py``). Defaults mirror reference wmf.py:11: lu = lv =
0.01, a = 1, b = 0.01.

The uniform [0, 1) init comes from ``np.random.default_rng(seed)``, the
same NumPy draws as the JAX package's, so the two trainers can be held to
each other value for value. During ``train`` the tables are the buffers of
an :class:`ALSTables` on the model's device; each iteration reads its loss
once, and each block of a half-sweep waits on the card once
(``batched_solve``); afterwards ``fue``/``fie`` are host arrays again. Each
half-sweep is an ``als.half_sweep`` span (``tracing.py``).

With a ``mesh`` (``set_mesh``), every half-sweep runs through the
distributed sweep (``parallel/als.py``), its slots split over the mesh's
ranks; every rank ends each sweep holding the full tables. CER and DPM
inherit it.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..data.io import write_dat
from ..tracing import span
from ..utils import tprint
from ..utils.statelog import StateLog
from ..ops.als import ALSPlan, half_sweep
from .base import Recommender


class ALSTables(nn.Module):
    """The ALS family's tables as buffers: ``U`` [n_users, k], ``V``
    [n_items, k] and, for CER, ``E`` [d, k]. Each is a float32 copy of the
    array given."""

    def __init__(self, device, **tables):
        super().__init__()
        for name, val in tables.items():
            self.register_buffer(name, torch.tensor(
                np.asarray(val, np.float32), device=device))


class WMF(Recommender):
    def __init__(
        self,
        k: int,
        lu: float = 0.01,
        lv: float = 0.01,
        a: float = 1.0,
        b: float = 0.01,
        seed: int = 0,
        block_size: int = 2048,
        device="cuda",
        mesh=None,
    ):
        """With a ``mesh`` the model lives on the mesh's device and
        ``device`` is not read."""
        super().__init__(k, mesh.device if mesh is not None else device)
        self.lu = lu
        self.lv = lv
        self.a = a
        self.b = b
        self.seed = seed
        self.block_size = block_size
        self._user_plan: Optional[ALSPlan] = None
        self._item_plan: Optional[ALSPlan] = None
        self.tables: Optional[ALSTables] = None
        self._half_sweep = half_sweep
        self.mesh = None
        if mesh is not None:
            self.set_mesh(mesh)

    def set_mesh(self, mesh) -> None:
        """Route every ALS half-sweep through the distributed sweep
        (wmf.py:56-63); the model must live on the mesh's device."""
        from ..parallel.als import DistributedALS

        if mesh.device != self.device:
            raise ValueError(f"the model lives on {self.device}, this "
                             f"rank's mesh device is {mesh.device}")
        self.mesh = mesh
        self._half_sweep = DistributedALS(mesh).half_sweep

    def _on_data_loaded(self) -> None:
        inter = self.inter
        dev = self.device
        self._user_plan = ALSPlan(*inter.user_csr, inter.n_users,
                                  self.block_size, device=dev)
        self._item_plan = ALSPlan(*inter.item_csr, inter.n_items,
                                  self.block_size, device=dev)
        # uniform [0,1) init (ref wmf.py:55-56), JAX's NumPy draws
        rng = np.random.default_rng(self.seed)
        self.fue = rng.random((inter.n_users, self.k), dtype=np.float32)
        self.fie = rng.random((inter.n_items, self.k), dtype=np.float32)
        self._rated_items = torch.from_numpy(inter.rated_items).to(dev)
        self._rated_users = torch.from_numpy(inter.rated_users).to(dev)
        self.tables = None

    def _device_tables(self, **extra) -> ALSTables:
        """Fresh device tables from the host ``fue``/``fie`` (and
        ``extra``)."""
        self.tables = ALSTables(self.device, U=self.fue, V=self.fie, **extra)
        return self.tables

    def _sweeps(self, prior: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One ALS iteration on the device tables (users, then items with
        the optional item ``prior``); returns the item fit loss as a 0-d
        tensor (wmf.py:92-122)."""
        t = self.tables if self.tables is not None else self._device_tables()
        with span("als.half_sweep"):
            t.U, _ = self._half_sweep(self._user_plan, t.U, t.V,
                                      self._rated_items, self.a, self.b,
                                      self.lu, as_numpy=False)
        with span("als.half_sweep"):
            t.V, fit = self._half_sweep(self._item_plan, t.V, t.U,
                                        self._rated_users, self.a, self.b,
                                        self.lv, prior=prior, as_numpy=False)
        return fit

    def _save_lag_dump(self, save_dir: str, it: int) -> None:
        """``%04d-U.dat`` / ``%04d-V.dat`` (old/cr/cr.cpp:284-295)."""
        os.makedirs(save_dir, exist_ok=True)
        write_dat(os.path.join(save_dir, "%04d-U.dat" % it),
                  self.tables.U.cpu().numpy())
        write_dat(os.path.join(save_dir, "%04d-V.dat" % it),
                  self.tables.V.cpu().numpy())

    def _loss_reg(self, theta: Optional[torch.Tensor] = None) -> torch.Tensor:
        """0.5·lu·‖U‖² + 0.5·lv·‖V‖² of the device tables, with ‖V−θ‖² in
        place of ‖V‖² under a content prior (wmf.py:133-147); a 0-d tensor,
        read by the caller's one sync per iteration."""
        t = self.tables if self.tables is not None else self._device_tables()
        item_term = t.V if theta is None else t.V - theta
        return (0.5 * self.lu * (t.U ** 2).sum()
                + 0.5 * self.lv * (item_term ** 2).sum())

    def _sync_host(self) -> None:
        """``fue``/``fie`` as writable host arrays of the device tables."""
        self.fue = self.tables.U.cpu().numpy().copy()
        self.fie = self.tables.V.cpu().numpy().copy()

    def train(
        self,
        max_iter: int = 200,
        tol: float = 1e-4,
        model_path: Optional[str] = None,
        verbose: bool = True,
        log_dir: Optional[str] = None,
        save_lag: Optional[int] = None,
        save_dir: Optional[str] = None,
        theta: Optional[np.ndarray] = None,
    ) -> None:
        """ALS until the loss changes by less than ``tol`` relatively
        (wmf.py:149-227).

        ``log_dir`` writes ``state.log`` / ``settings.txt``; ``save_lag``
        dumps ``%04d-U/V.dat`` into ``save_dir`` every that many
        iterations. ``theta`` [n_items, k] (the cr solver's
        ``--theta_init``) initializes V and enters every item solve as the
        lv-weighted prior; a warm start from ``model_path`` overrides the V
        init (cr.cpp:118-122).
        """
        if self.inter is None:
            raise ValueError("no training data loaded")
        if theta is not None:
            theta = np.asarray(theta, dtype=np.float32)
            if theta.shape != (self.inter.n_items, self.k):
                raise ValueError(
                    "theta shape %s != (n_items=%d, k=%d)"
                    % (theta.shape, self.inter.n_items, self.k))
            self.fie = theta.copy()
        if model_path is not None and os.path.isdir(model_path):
            self.import_embeddings(model_path)
        slog = StateLog(log_dir, {
            "model": type(self).__name__.lower(), "k": self.k,
            "lu": self.lu, "lv": self.lv, "a": self.a, "b": self.b,
            "max_iter": max_iter, "tol": tol,
        })
        self._device_tables()
        prior = (None if theta is None
                 else torch.from_numpy(theta).to(self.device))
        loss = np.exp(50)
        for it in range(max_iter):
            t1 = time.time()
            fit = self._sweeps(prior)
            loss_old, loss = loss, float(fit + self._loss_reg(prior))
            cond = abs(loss_old - loss) / loss_old
            slog.append(it, loss, cond)
            if save_lag and save_dir and it % save_lag == 0:
                self._save_lag_dump(save_dir, it)
            if verbose:
                tprint("Iter %3d, loss %.6f, converge %.6f, time %.2fs"
                       % (it, loss, cond, time.time() - t1))
            if cond < tol:
                break
        self._sync_host()
