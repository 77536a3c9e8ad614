"""Plain top-k of unseen items: the served lists' reference.

Scores are ``U[u] · Vᵀ + b`` on inputs rounded to the serving type and
summed in float64; the user's seen items are excluded; the top ``k`` are
taken in descending order, ties to the lowest item id."""

from __future__ import annotations

import torch

from .precision import ROUNDINGS


def seen_rows(indptr: torch.Tensor, items: torch.Tensor, users: torch.Tensor,
              n_items: int) -> torch.Tensor:
    """bool [len(users), n_items]: the seen items of each user, from the
    CSR (``indptr``, ``items``) of the training pairs."""
    users = users.long()
    lo, hi = indptr[users], indptr[users + 1]
    counts = hi - lo
    rows = torch.repeat_interleave(torch.arange(users.numel(),
                                                device=users.device), counts)
    offs = torch.arange(int(counts.sum()), device=users.device) - \
        torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    mask = torch.zeros(users.numel(), n_items, dtype=torch.bool,
                       device=users.device)
    mask[rows, items[torch.repeat_interleave(lo, counts) + offs].long()] = True
    return mask


def scores(U, V, B, users, rounding: str) -> torch.Tensor:
    """float64 [len(users), n_items] scores on rounded inputs."""
    r = ROUNDINGS[rounding]
    u = r(U[users.long()]).double()
    v = r(V).double()
    return u @ v.T + B.double()[None, :]


def topk_unseen(s: torch.Tensor, seen: torch.Tensor, k: int):
    """(values, item ids) [rows, k], descending, ties to the lowest id."""
    s = s.masked_fill(seen, -torch.inf)
    vals, idx = torch.sort(s, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]
