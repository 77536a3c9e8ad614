"""Plain BPR and VBPR steps with sparse RMSProp, in any float type.

The losses follow the reference's single/bpr.py:87-99 and
single/vbpr.py:59-75 (l2 regularization), and the optimizer TF1's RMSProp
on IndexedSlices as the reference trains its embeddings: the gradients of
a row's occurrences in a batch are summed, and only the rows the batch
touches advance, each once:

    ms <- 0.9 · ms + 0.1 · g²        p <- p - lr · g / sqrt(ms + 1e-10)

The content projection ``cem`` and bias ``icb`` of VBPR are dense and
advance every step. Gradients come from ``torch.autograd`` on whole
tables, so every row's gradient is the sum over its occurrences.

``run_steps`` takes the initial parameters (a dict of tensors), the
triplets of each step and the hyper-parameters, and returns the loss of
each step and the parameters and accumulators after the last step, all
computed in ``dtype``."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

DECAY, EPS = 0.9, 1e-10


def _touched(n: int, rows: Sequence[torch.Tensor], device) -> torch.Tensor:
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    for r in rows:
        mask[r] = True
    return mask


def _rmsprop(p, ms, g, mask, lr):
    """RMSProp on the rows of ``mask`` (all rows where it is None)."""
    if mask is None:
        ms.mul_(DECAY).add_((1 - DECAY) * g * g)
        p.sub_(lr * g / torch.sqrt(ms + EPS))
        return
    ms[mask] = DECAY * ms[mask] + (1 - DECAY) * g[mask] * g[mask]
    p[mask] = p[mask] - lr * g[mask] / torch.sqrt(ms[mask] + EPS)


def _softplus_neg(x):
    return torch.logaddexp(torch.zeros((), dtype=x.dtype, device=x.device),
                           -x)


def bpr_loss(p: Dict[str, torch.Tensor], u, i, j, hyper) -> torch.Tensor:
    pu, pi, pj = p["ue"][u], p["ie"][i], p["ie"][j]
    bi, bj = p["ib"][i], p["ib"][j]
    x = bi - bj + (pu * (pi - pj)).sum(1)
    reg = (0.5 * (hyper["lu"] * (pu * pu).sum(1) + hyper["li"] * (pi * pi).sum(1)
                  + hyper["lj"] * (pj * pj).sum(1))
           + 0.5 * hyper["lb"] * (bi * bi + bj * bj))
    return (_softplus_neg(x) + reg).sum()


def vbpr_loss(p: Dict[str, torch.Tensor], u, i, j, feat, hyper):
    ic, jc = feat[i], feat[j]
    ure, uce = p["ure"][u], p["uce"][u]
    iri, irj = p["ire"][i], p["ire"][j]
    bi, bj = p["irb"][i], p["irb"][j]
    x = (bi - bj + (ure * (iri - irj)).sum(1)
         + (uce * (ic @ p["cem"] - jc @ p["cem"])).sum(1)
         + (ic - jc) @ p["icb"])
    reg = (0.5 * ((ure * ure + uce * uce).sum() * hyper["lu"]
                  + (iri * iri).sum() * hyper["li"]
                  + (irj * irj).sum() * hyper["lj"])
           + 0.5 * hyper["lb"] * ((bi * bi).sum() + (bj * bj).sum())
           + 0.5 * hyper["le"] * (p["cem"] ** 2).sum()
           + 0.5 * hyper["lb"] * (p["icb"] ** 2).sum())
    return _softplus_neg(x).sum() + reg


# the rows each leaf's gradient touches: "u" the users, "ij" the items;
# None marks a dense leaf
BPR_LEAVES = {"ue": "u", "ie": "ij", "ib": "ij"}
VBPR_LEAVES = {"ure": "u", "uce": "u", "ire": "ij", "irb": "ij",
               "cem": None, "icb": None}


def run_steps(model: str, init: Dict[str, torch.Tensor],
              triplets: Sequence[Tuple[torch.Tensor, ...]], hyper: dict,
              dtype: torch.dtype, feat=None
              ) -> Tuple[List[float], Dict[str, torch.Tensor],
                         Dict[str, torch.Tensor]]:
    """(loss of each step, parameters and accumulators after the last
    step) of ``model`` ("bpr" or "vbpr") from ``init``; ``triplets`` holds
    one (u, i, j) per step."""
    leaves = BPR_LEAVES if model == "bpr" else VBPR_LEAVES
    p = {n: init[n].to(dtype).clone() for n in leaves}
    ms = {n: torch.zeros_like(t) for n, t in p.items()}
    f = None if feat is None else feat.to(dtype)
    lr = hyper["lr"]
    losses = []
    for u, i, j in triplets:
        u, i, j = u.long(), i.long(), j.long()
        q = {n: t.detach().clone().requires_grad_() for n, t in p.items()}
        loss = (bpr_loss(q, u, i, j, hyper) if model == "bpr"
                else vbpr_loss(q, u, i, j, f, hyper))
        grads = dict(zip(q, torch.autograd.grad(loss, list(q.values()))))
        masks = {"u": _touched(p[next(iter(p))].shape[0], [u], u.device)}
        n_items = p["ie" if model == "bpr" else "ire"].shape[0]
        masks["ij"] = _touched(n_items, [i, j], u.device)
        with torch.no_grad():
            for n, rows in leaves.items():
                _rmsprop(p[n], ms[n], grads[n],
                         None if rows is None else masks[rows], lr)
        losses.append(float(loss.detach()))
    return losses, p, ms
