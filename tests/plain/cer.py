"""Plain CER in float64: the reference that the port's ``CER.train`` is held
to. It imports neither JAX nor either package of the repo, and no kernel.

What it computes, from the reference's single/cer.py:24-73, one iteration
after another from the given U, V and E:

* ``Fe = F·E``;
* every user u with rated items I_u over the rated items' rows V_r:
  ``(b·V_rᵀV_r + (a-b)·Σ_{j∈I_u} v_j v_jᵀ + lu·I) x_u = a·Σ_{j∈I_u} v_j``;
  a user with none keeps its row;
* every item i the same over the rated users' rows U_r with ``lv`` and the
  prior ``lv·Fe_i`` added to the right-hand side; an item nobody rated is
  solved from the prior alone;
* E by an exact solve: the Woodbury form ``lv·Fᵀ(le·I + lv·F·Fᵀ)⁻¹·V``
  when d > n_items, else ``(lv·FᵀF + le·I)⁻¹·lv·Fᵀ·V``;
* the loss as ``CER.train`` sums it: the item side's weighted squared error
  ``0.5·Σ c_ui (r_ui - u·v_i)²`` over the rated users and the items with a
  rating (c = a on a rating, b elsewhere), plus ``0.5·lu·‖U‖²``,
  ``0.5·lv·‖V - Fe‖²`` with the iteration's first ``Fe``, and
  ``0.5·le·‖E‖²``;
* after the last iteration, the cold-start write-back: every item nobody
  rated takes its row of ``F·E``.

The sums run over a dense 0/1 matrix of the pairs, a block of users at a
time (so the pairs must be distinct). Where it departs from the program on
purpose:

* E is solved exactly; the program runs conjugate gradients on the Woodbury
  form to a relative residual of 1e-6, and clamps CG's denominators at
  1e-30;
* each k x k system gets the jitter the program's (and the JAX package's)
  solver adds, 1e-6·trace/k on the diagonal, and is solved by LU in the
  reference's type rather than by a Cholesky factorization.

``state_rounding`` (a function) is applied to U, V and E each time one is
computed: the controls hold the tables in a type below float32 so.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

JITTER = 1e-6     # the solver's diagonal jitter, relative to trace/k
USER_BLOCK = 4096  # users whose dense rows are formed at once


def _no_tf32(device) -> None:
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _solve(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """A x = rhs for a batch of k x k systems, after the jitter."""
    k = A.shape[-1]
    scale = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / k
    eye = torch.eye(k, dtype=A.dtype, device=A.device)
    A = A + JITTER * scale[:, None, None] * eye
    return torch.linalg.solve(A, rhs.unsqueeze(-1)).squeeze(-1)


def _dense_rows(users: torch.Tensor, items: torch.Tensor, lo: int, hi: int,
                n_items: int, dtype) -> torch.Tensor:
    """The 0/1 rows [hi - lo, n_items] of the users lo..hi-1."""
    sel = (users >= lo) & (users < hi)
    R = torch.zeros(hi - lo, n_items, dtype=dtype, device=users.device)
    R[users[sel] - lo, items[sel]] = 1.0
    return R


def _outer_rows(X: torch.Tensor) -> torch.Tensor:
    """[n, k·k]: each row's x xᵀ, flattened."""
    return (X[:, :, None] * X[:, None, :]).reshape(X.shape[0], -1)


class PlainCER:
    """The fold (distinct training pairs), the features and the settings;
    :meth:`run` iterates from given tables."""

    def __init__(self, users: torch.Tensor, items: torch.Tensor, n_users: int,
                 n_items: int, F: torch.Tensor, hyper: Dict[str, float],
                 dtype=torch.float64, user_block: int = USER_BLOCK):
        _no_tf32(users.device)
        self.u, self.i = users.long(), items.long()
        self.n_users, self.n_items = n_users, n_items
        self.dtype, self.block = dtype, user_block
        self.h = {n: float(hyper[n]) for n in ("lu", "lv", "le", "a", "b")}
        self.F = F.to(dtype)
        dev = users.device
        self.rated_users = torch.zeros(n_users, dtype=dtype, device=dev)
        self.rated_users[self.u] = 1.0
        self.rated_items = torch.zeros(n_items, dtype=dtype, device=dev)
        self.rated_items[self.i] = 1.0
        self.user_deg = torch.bincount(self.u, minlength=n_users)
        self._factor_e()

    def _factor_e(self) -> None:
        """The Cholesky factor of E's fixed system, once."""
        F, lv, le = self.F, self.h["lv"], self.h["le"]
        n, d = F.shape
        self.woodbury = d > n
        M = F @ F.T if self.woodbury else F.T @ F
        eye = torch.eye(M.shape[0], dtype=self.dtype, device=F.device)
        self.e_factor = torch.linalg.cholesky(le * eye + lv * M)

    def solve_e(self, V: torch.Tensor) -> torch.Tensor:
        lv = self.h["lv"]
        if self.woodbury:
            return lv * (self.F.T @ torch.cholesky_solve(V, self.e_factor))
        return torch.cholesky_solve(lv * (self.F.T @ V), self.e_factor)

    def _blocks(self):
        for lo in range(0, self.n_users, self.block):
            hi = min(lo + self.block, self.n_users)
            yield lo, hi, _dense_rows(self.u, self.i, lo, hi, self.n_items,
                                      self.dtype)

    def user_side(self, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        a, b, lu = self.h["a"], self.h["b"], self.h["lu"]
        k = V.shape[1]
        Vr = V * self.rated_items[:, None]
        base = b * (Vr.T @ Vr) + lu * torch.eye(k, dtype=self.dtype,
                                                device=V.device)
        VV = _outer_rows(V)
        out = torch.empty_like(U)
        for lo, hi, R in self._blocks():
            A = base + (a - b) * (R @ VV).view(hi - lo, k, k)
            x = _solve(A, a * (R @ V))
            rated = (self.user_deg[lo:hi] > 0)[:, None]
            out[lo:hi] = torch.where(rated, x, U[lo:hi])
        return out

    def item_side(self, U: torch.Tensor, prior: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(new V, the weighted squared error of the items with a
        rating)."""
        a, b, lv = self.h["a"], self.h["b"], self.h["lv"]
        k = U.shape[1]
        Ur = U * self.rated_users[:, None]
        P = torch.zeros(self.n_items, k * k, dtype=self.dtype,
                        device=U.device)
        s = torch.zeros(self.n_items, k, dtype=self.dtype, device=U.device)
        for lo, hi, R in self._blocks():
            P += R.T @ _outer_rows(U[lo:hi])
            s += R.T @ U[lo:hi]
        eye = torch.eye(k, dtype=self.dtype, device=U.device)
        A = b * (Ur.T @ Ur) + lv * eye + (a - b) * P.view(-1, k, k)
        V = _solve(A, a * s + lv * prior)
        fit = torch.zeros((), dtype=self.dtype, device=U.device)
        cols = self.rated_items > 0
        for lo, hi, R in self._blocks():
            err = R - U[lo:hi] @ V.T
            c = b + (a - b) * R
            rows = (self.rated_users[lo:hi] > 0)[:, None]
            fit += 0.5 * (c * err * err)[rows.expand_as(err)
                                         & cols[None, :]].sum()
        return V, fit

    def run(self, U0, V0, E0, n_iter: int,
            state_rounding: Optional[Callable] = None
            ) -> Tuple[List[float], torch.Tensor, torch.Tensor, torch.Tensor]:
        """(each iteration's loss, U, V after the write-back, E)."""
        def keep(x):
            return x if state_rounding is None else state_rounding(x).to(
                self.dtype)

        U, V, E = (keep(t.to(self.dtype)) for t in (U0, V0, E0))
        lu, lv, le = self.h["lu"], self.h["lv"], self.h["le"]
        losses = []
        for _ in range(n_iter):
            Fe = self.F @ E
            U = keep(self.user_side(U, V))
            V, fit = self.item_side(U, Fe)
            V = keep(V)
            E = keep(self.solve_e(V))
            loss = (fit + 0.5 * lu * (U * U).sum()
                    + 0.5 * lv * ((V - Fe) ** 2).sum()
                    + 0.5 * le * (E * E).sum())
            losses.append(float(loss))
        cold = self.rated_items == 0
        V = V.clone()
        V[cold] = keep((self.F @ E)[cold])
        return losses, U, V, E
