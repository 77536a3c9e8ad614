"""The comparisons that decide ``correct``: the program's outputs held to
the plain references of ``portbench/reference``.

Each function returns the numbers compared, each with the limit that the
configuration's ``limits`` give it for the traffic's kind. The numbers:

Training (``limits.train``), over the program's first chunk, which runs
through the window's own call at the window's steps and batch:
  ``bad_triplets``  triplets whose i is not a positive of u, whose j is,
                    or whose ids are out of range (limit 0);
  ``loss_gap``      the relative gap of the chunk's summed loss;
  ``acc_gap``       the largest gap of a leaf's RMSProp accumulator norm
                    after the chunk: every step's gradient as the
                    optimizer got it;
  ``change_gap``    the largest gap of a leaf's change of norm after the
                    chunk;
  a norm gap is |‖program‖ - ‖reference‖| over the larger of the leaf's
  reference norm and the median leaf's. ``change_gap`` leaves out the
  leaves whose reference gradient over the chunk (the norm of the square
  root of its accumulator) is under a thousandth of the median leaf's,
  which move by rounding alone.

Serving (``limits.serve``), over the sampled served batches:
  ``bad_served``    served ids out of range, repeated in a list, or seen
                    by the user (limit 0);
  ``rank_gap``      the largest amount by which the item served at a rank
                    scores below the reference's item at that rank;
  ``value_gap``     the largest gap between a served score and the
                    reference's score of that item.

Evaluation (``limits.evaluate``), over every ``evaluate`` in the window:
  ``acc_off``       the summed gap of the printed accuracies to the
                    reference's, in units of the last printed digit
                    (1e-6), the largest over the calls.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..reference import pairwise, protocol, topk
from .result import Check

GRAD_FLOOR = 1e-3   # leaves moved by rounding alone, relative to the median


def hyper(cfg: dict) -> Dict[str, float]:
    """The configuration's hyper-parameters under the references' names."""
    names = ("lu", "li", "lj", "lb", "lr") + (
        ("le",) if cfg["model"] == "vbpr" else ())
    return {n: float(cfg[n]) for n in names}


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             names: List[str]) -> float:
    rn = {n: float(ref[n].double().norm()) for n in ref}
    med = statistics.median(rn.values())
    return max(abs(float(prog[n].double().norm()) - rn[n]) / max(rn[n], med)
               for n in names)


def reference_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def bad_triplets(fold, triplets, device) -> int:
    """Triplets of (u, i, j) that break the sampler's guarantees."""
    keys = torch.as_tensor(fold.train_u * fold.n_items + fold.train_i,
                           device=device)
    u, i, j = (t.reshape(-1).to(device).long() for t in triplets)
    out = ((u < 0) | (u >= fold.n_users) | (i < 0) | (i >= fold.n_items)
           | (j < 0) | (j >= fold.n_items))

    def member(q):
        at = torch.searchsorted(keys, q).clamp(max=keys.numel() - 1)
        return keys[at] == q

    u, i, j = (t.clamp(0, n - 1) for t, n in
               ((u, fold.n_users), (i, fold.n_items), (j, fold.n_items)))
    return int((out | ~member(u * fold.n_items + i)
                | member(u * fold.n_items + j)).sum())


def train_numbers(cfg: dict, init, feat, warm, device="cpu"
                  ) -> Tuple[Dict[str, float], List[str]]:
    """The gaps of the program's first chunk (``warm``: its triplets,
    summed loss, tables and accumulators after it) to the float64
    reference on the same triplets, and the leaves ``change_gap`` leaves
    out."""
    dev = reference_device(device)
    init_r = {n: t.to(dev) for n, t in init.items()}
    u, i, j = (t.to(dev) for t in warm.triplets)
    losses, params, ms = pairwise.run_steps(
        cfg["model"], init_r, list(zip(u, i, j)), hyper(cfg), torch.float64,
        None if feat is None else feat.to(dev))
    ref_loss = sum(losses)
    names = list(ms)
    gnorm = {n: float(ms[n].double().sqrt().norm()) for n in names}
    med = statistics.median(gnorm.values())
    moving = [n for n in names if gnorm[n] >= GRAD_FLOOR * med]
    d_prog = {n: warm.params[n].double().to(dev) - init_r[n].double()
              for n in names}
    d_ref = {n: params[n].double() - init_r[n].double() for n in names}
    nums = {"loss_gap": abs(warm.loss - ref_loss) / abs(ref_loss),
            "acc_gap": norm_gap({n: warm.ms[n].to(dev) for n in names}, ms,
                                names),
            "change_gap": norm_gap(d_prog, d_ref, moving)}
    return nums, sorted(set(names) - set(moving))


def train(cfg: dict, fold, init, feat, warm, device) -> List[Check]:
    lim = cfg["limits"]["train"]
    dev = reference_device(device)
    found = [Check("bad_triplets",
                   float(bad_triplets(fold, warm.triplets, dev)),
                   lim["bad_triplets"])]
    nums, _ = train_numbers(cfg, init, feat, warm, device=dev)
    return found + [Check(n, v, lim[n]) for n, v in nums.items()]


def user_csr(fold, device):
    indptr = np.zeros(fold.n_users + 1, np.int64)
    np.cumsum(np.bincount(fold.train_u, minlength=fold.n_users),
              out=indptr[1:])
    return (torch.as_tensor(indptr, device=device),
            torch.as_tensor(fold.train_i, device=device))


def serve_numbers(fold, U, V, B, served, k: int, rounding: str,
                  device) -> Dict[str, float]:
    """``served``: (user ids, item ids [n, k], scores [n, k]) of each kept
    batch; the reference scores on inputs rounded to ``rounding``."""
    dev = reference_device(device)
    indptr, items = user_csr(fold, dev)
    U, V, B = U.to(dev), V.to(dev), B.to(dev)
    bad, rank_gap, value_gap = 0, 0.0, 0.0
    for uids, ids, vals in served:
        users = torch.as_tensor(np.asarray(uids), device=dev)
        ids = torch.as_tensor(np.asarray(ids), device=dev).long()
        vals = torch.as_tensor(np.asarray(vals), device=dev).double()
        seen = topk.seen_rows(indptr, items, users, fold.n_items)
        s = topk.scores(U, V, B, users, "bf16")
        ref_vals, _ = topk.topk_unseen(s, seen, k)
        valid = (ids >= 0) & (ids < fold.n_items)
        safe = ids.clamp(0, fold.n_items - 1)
        srt = torch.sort(safe, dim=1).values
        repeat = torch.zeros_like(valid)
        repeat[:, 1:] = srt[:, 1:] == srt[:, :-1]
        bad += int((~valid | seen.gather(1, safe)).sum() + repeat.sum())
        got = s.gather(1, safe)
        rank_gap = max(rank_gap, float((ref_vals - got).max()))
        value_gap = max(value_gap, float((vals - got).abs().max()))
    return {"bad_served": float(bad), "rank_gap": rank_gap,
            "value_gap": value_gap}


def serve(cfg: dict, fold, U, V, B, served, k: int, device) -> List[Check]:
    lim = cfg["limits"]["serve"]
    nums = serve_numbers(fold, U, V, B, served, k, "bf16", device)
    return [Check(n, v, lim[n]) for n, v in nums.items()]


def reference_lines(fold, U, V, B, scenarios, step: int, total: int,
                    rounding: str, device) -> Dict[str, str]:
    """The reference's accuracy line of each scenario."""
    dev = reference_device(device)
    indptr, items = user_csr(fold, dev)
    U, V, B = (torch.as_tensor(np.asarray(a), device=dev) for a in (U, V, B))
    out = {}
    for name in scenarios:
        cand, lu, li = fold.scenario(name)
        h = protocol.hits(U, V, B, torch.as_tensor(cand, device=dev), indptr,
                          items, torch.as_tensor(lu, device=dev),
                          torch.as_tensor(li, device=dev), step, total,
                          rounding)
        out[name] = protocol.lines(h, int(lu.size), name)
    return out


def acc_off(printed: List[str], ref: Dict[str, str]) -> float:
    """Summed gap of one call's printed accuracies to the reference's,
    in units of 1e-6; inf when a scenario's line is missing or malformed."""
    got = {ln.split(",")[0]: ln for ln in printed}
    total = 0.0
    for name, want in ref.items():
        line = got.get(name)
        if line is None:
            return float("inf")
        a, b = line.split(",")[1:], want.split(",")[1:]
        if len(a) != len(b):
            return float("inf")
        total += sum(abs(round(float(x) * 1e6) - round(float(y) * 1e6))
                     for x, y in zip(a, b))
    return total


def evaluate(cfg: dict, printed_calls: List[List[str]], ref: Dict[str, str]
             ) -> List[Check]:
    lim = cfg["limits"]["evaluate"]
    worst = max((acc_off(p, ref) for p in printed_calls), default=float("inf"))
    return [Check("acc_off", worst, lim["acc_off"])]
