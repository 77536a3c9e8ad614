"""Plain accuracy@k of the reference's evaluation protocol
(evaluate.py:72-117).

For each user, the candidates are ranked by ``U[u] · V[c] + b[c]`` in
descending order, ties to the lowest item id, skipping the items the user
saw in training; a liked test item at unseen rank ``r`` (from 0) is a hit
at every cut-off ``n · step`` with ``r < n · step``, up to ``total``.
accuracy@(n · step) is the number of such hits over all users, divided by
the number of liked test items of the scenario. Scores are float64 sums
of products of inputs rounded to ``rounding`` ("fp32": as given)."""

from __future__ import annotations

from typing import List

import torch

from .precision import ROUNDINGS
from .topk import seen_rows

USER_BLOCK = 4096


def hits(U, V, B, cand, seen_indptr, seen_items, like_u, like_i, step: int,
         total: int, rounding: str = "fp32") -> List[int]:
    """Hits at each cut-off step, 2·step, ..., total; tensors on one
    device: ``cand`` the candidates ascending, (``seen_indptr``,
    ``seen_items``) the CSR of training pairs, (``like_u``, ``like_i``)
    the liked test pairs."""
    r = ROUNDINGS[rounding]
    dev = U.device
    n_users, n_items = U.shape[0], V.shape[0]
    cand = cand.long()
    vc = r(V[cand]).double()
    bc = B.double()[cand]
    cuts = list(range(step, total + 1, step))
    out = torch.zeros(len(cuts), dtype=torch.int64, device=dev)
    for lo in range(0, n_users, USER_BLOCK):
        hi = min(lo + USER_BLOCK, n_users)
        users = torch.arange(lo, hi, device=dev)
        s = r(U[lo:hi]).double() @ vc.T + bc[None, :]
        seen = seen_rows(seen_indptr, seen_items, users, n_items)[:, cand]
        s = s.masked_fill(seen, -torch.inf)
        order = torch.sort(s, dim=1, descending=True, stable=True).indices
        top = cand[order[:, :total]]                      # item ids
        sel = (like_u >= lo) & (like_u < hi)
        lk = torch.zeros(hi - lo, n_items, dtype=torch.bool, device=dev)
        lk[like_u[sel].long() - lo, like_i[sel].long()] = True
        hit = lk.gather(1, top)
        for n, cut in enumerate(cuts):
            out[n] += hit[:, :cut].sum()
    return out.tolist()


def lines(hit_counts: List[int], count: int, scenario: str) -> str:
    """The ``scenario,acc@5,...`` line as the reference prints it."""
    return scenario + "".join(",%.6f" % (h / count if count else 0.0)
                              for h in hit_counts)
