"""On-device top-k evaluation: chunked U·Vᵀ scoring + seen-mask + top-k.

Counterpart of ``topk_rec_tpu/eval/device.py``. Two engines score each
user chunk:

* ``use_kernel=False`` (CLI ``--engine torch``, JAX's ``xla``): an fp32
  ``torch.matmul`` (TF32 off), a dense bit expansion of the seen words and
  a stable sort, so ties keep the lowest index first as ``lax.top_k`` does;
* ``use_kernel=True`` (CLI ``--engine kernel``, JAX's ``pallas``): the fused
  kernel K1 (``ops/topk_fused.py``), which never materializes the scores.

Bitmaps live on the device as ``int32`` tensors holding the uint32 words'
bits. Results come back to the host once, after every chunk is queued.
The reciprocal-rank reconstruction and hit counting follow the JAX module
line for line, but for the like bitmap, which is built in a few array
operations instead of its loop over every like; ``evaluate_oracle``
(``topk_rec_tpu/eval/protocol.py``) stays the specification.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..tracing import span
from ..ops.topk_fused import (
    NEG_INF,
    bitmap_tensor,
    expand_seen_mask,
    fused_score_topk,
    kernel_table,
    kernel_width,
    pack_mask,
    topk_stable,
)
from .protocol import EvalResult


def _to_dev(a: Optional[np.ndarray], dev) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(dev)


def _scores(u_emb, v_cand, bias):
    """fp32 U·Vᵀ (+ bias): the protocol ranks by exact scores (eval/device.py
    :90-101 uses Precision.HIGHEST for the same reason)."""
    scores = u_emb @ v_cand.T
    if bias is not None:
        scores = scores + bias[None, :]
    return scores


def _mask_topk(scores, packed_seen, n_cand: int, k: int):
    """eval/device.py:28-43: seen candidates -> -inf, then top-k."""
    seen = expand_seen_mask(packed_seen, n_cand) != 0
    return topk_stable(scores.masked_fill(seen, -torch.inf), k)


def _seen_above_from_scores(scores, packed_seen, idx, n_cand: int):
    """Per returned candidate: # of SEEN candidates scoring strictly above
    (eval/device.py:46-67). Unseen rank + this count is the raw rank the
    reference walks, which the reciprocal-rank metric needs. Empty slots
    (index -1) are clamped; their values are -inf and never count."""
    seen = expand_seen_mask(packed_seen, n_cand) != 0
    vals = scores.gather(1, idx.long().clamp(min=0))
    ss = torch.sort(scores.masked_fill(~seen, -torch.inf), dim=1).values
    pos = torch.searchsorted(ss, vals, right=True)
    return (n_cand - pos).to(torch.int32)


def _raw_rank_scores(u_emb, v_cand, bias, packed_seen, idx, n_cand: int):
    return _seen_above_from_scores(
        _scores(u_emb, v_cand, bias), packed_seen, idx, n_cand
    )


def _score_topk_chunk(u_emb, v_cand, bias, packed_seen, n_cand: int, k: int):
    return _mask_topk(_scores(u_emb, v_cand, bias), packed_seen, n_cand, k)


def _kernel_chunk(u_emb, v_cand, bias, packed_seen, n_cand: int, k: int):
    """Fused-kernel variant of _score_topk_chunk (eval/device.py:173-186):
    empty slots come back at float32.min and become -inf here, so both
    engines report unseen-deficit users alike (``_count_hits`` counts every
    finite value as valid)."""
    vals, idx = fused_score_topk(u_emb, v_cand, bias, packed_seen, k)
    return torch.where(vals <= NEG_INF, -torch.inf, vals), idx


def _chunked(U, v_dev, b_dev, bm_dev, rr_dev, n_cand, k, user_chunk,
             use_kernel, dev):
    """Score every user chunk on the device; fetch once at the end."""
    step = _kernel_chunk if use_kernel else _score_topk_chunk
    # K1 reads its tables padded (ops/topk_fused.py:kernel_table): the
    # candidates are padded once here, and each chunk of users on the host
    # before its copy, so that no launch pads a table on the card
    pad = use_kernel and dev.type == "cuda"
    v_step = kernel_table(v_dev) if pad else v_dev
    d = U.shape[1]
    vals, idxs, sas = [], [], []
    with span("eval.score"):
        for start in range(0, U.shape[0], user_chunk):
            stop = min(start + user_chunk, U.shape[0])
            if pad:
                u_host = np.zeros((stop - start, kernel_width(d)),
                                  np.float32)
                u_host[:, :d] = U[start:stop]
                u_step = _to_dev(u_host, dev)
                u_dev = u_step[:, :d]
            else:
                u_dev = u_step = _to_dev(U[start:stop], dev)
            v, i = step(u_step, v_step, b_dev, bm_dev[start:stop], n_cand, k)
            vals.append(v)
            idxs.append(i.to(torch.int32))
            if rr_dev is not None:
                sas.append(_raw_rank_scores(
                    u_dev, v_dev, b_dev, rr_dev[start:stop], i, n_cand
                ))
    with span("eval.fetch"):
        out = [torch.cat(vals).cpu().numpy(), torch.cat(idxs).cpu().numpy()]
        if rr_dev is not None:
            out.append(torch.cat(sas).cpu().numpy())
    return tuple(out)


def topk_unseen(
    U: np.ndarray,
    V_cand: np.ndarray,
    bias: Optional[np.ndarray],
    seen_bitmap: np.ndarray,
    cand_item_ids: np.ndarray,
    k: int,
    user_chunk: int = 8192,
    use_kernel: bool = False,
    want_raw_rank: bool = False,
    device="cuda",
):
    """Top-k *unseen* candidates per user, descending (eval/device.py:104-170).

    Returns numpy (values, indices[, seen_above]) [n_users, k]; slots whose
    value is -inf mean fewer than k unseen candidates and must be ignored.
    """
    dev = resolve_device(device)
    n_cand = V_cand.shape[0]
    k = min(k, n_cand)
    bm_dev = candidate_words(seen_bitmap, cand_item_ids, dev)
    return _chunked(
        U, _to_dev(V_cand, dev),
        _to_dev(None if bias is None else np.reshape(bias, -1), dev),
        bm_dev, bm_dev if want_raw_rank else None, n_cand, k, user_chunk,
        use_kernel, dev,
    )


def candidate_words(seen_bitmap, cand_item_ids, device="cuda",
                    user_chunk: int = 8192) -> torch.Tensor:
    """The seen bitmap re-packed into candidate space on the device: int32
    words [n_users, ceil(n_cand/32)], bit c of user u = seen bit
    ``cand_item_ids[c]``. ``seen_bitmap`` is uint32 words [n_users,
    ceil(n_items/32)], numpy or already on the device. The host's
    ``pack_candidate_bitmap`` (``ops/topk_fused.py``, the JAX package's
    way) takes seconds at the MovieLens width and stays as the tests'
    reference."""
    dev = resolve_device(device)
    bits = (seen_bitmap.to(dev) if isinstance(seen_bitmap, torch.Tensor)
            else bitmap_tensor(seen_bitmap, dev))
    cand = torch.from_numpy(np.asarray(cand_item_ids, dtype=np.int64)).to(dev)
    n_items = bits.shape[1] * 32
    return torch.cat([
        pack_mask(expand_seen_mask(bits[s:s + user_chunk], n_items)[:, cand])
        for s in range(0, bits.shape[0], user_chunk)])


def topk_unseen_scorer(
    scorer,
    n_users: int,
    n_cand: int,
    seen_bitmap: np.ndarray,
    cand_item_ids: np.ndarray,
    k: int,
    user_chunk: int = 8192,
    packed_seen: Optional[np.ndarray] = None,
    want_rr: bool = True,
    device="cuda",
):
    """Top-k unseen candidates from an arbitrary chunk scorer
    (eval/device.py:189-236).

    ``scorer(start, stop)`` returns the scores [stop - start, n_cand] of
    that user range on ``device`` (the fusion engine combines its
    modalities there, chunk by chunk). The candidate-space seen bitmap is
    ``packed_seen`` (host words or device int32 words) when given, else
    packed from ``seen_bitmap`` on the device (:func:`candidate_words`).
    ``want_rr`` adds the raw-rank counts (a sort per chunk) and returns
    None for them otherwise. Every chunk is queued before the results are
    fetched.
    """
    dev = resolve_device(device)
    k = min(k, n_cand)
    if packed_seen is None:
        bm_dev = candidate_words(seen_bitmap, cand_item_ids, dev)
    elif isinstance(packed_seen, torch.Tensor):
        bm_dev = packed_seen.to(dev)
    else:
        bm_dev = bitmap_tensor(packed_seen, dev)
    vals, idxs, sas = [], [], []
    for start in range(0, n_users, user_chunk):
        stop = min(start + user_chunk, n_users)
        scores = scorer(start, stop)
        v, i = _mask_topk(scores, bm_dev[start:stop], n_cand, k)
        vals.append(v)
        idxs.append(i.to(torch.int32))
        if want_rr:
            sas.append(_seen_above_from_scores(scores, bm_dev[start:stop], i,
                                               n_cand))
    out_sa = torch.cat(sas).cpu().numpy() if want_rr else None
    return torch.cat(vals).cpu().numpy(), torch.cat(idxs).cpu().numpy(), out_sa


def _count_hits(
    top_idx: np.ndarray,
    top_vals: np.ndarray,
    seen_above: Optional[np.ndarray],
    likes: Dict[int, Sequence[int]],
    n_cand: int,
    step: int,
    total: int,
) -> EvalResult:
    """Bucketed hit counting on the host, carried over from
    eval/device.py:239-285: hits bucket by unseen rank (reference
    evaluate.py:100); reciprocal ranks by raw rank ``unseen rank +
    seen_above`` with value 1/(t+1) (reference utils.py:116-119). The
    users' like lists (lists, tuples or integer arrays of candidate
    positions) are packed into one bitmap row each in a few array
    operations."""
    with span("eval.count_hits"):
        interval = total // step
        users = np.array([u for u, l in likes.items() if len(l) > 0],
                         dtype=np.int64)
        count = sum(len(l) for l in likes.values())
        if users.size == 0:
            return EvalResult(
                hits=np.zeros(interval), rr=np.zeros(interval), count=count
            )
        n_words = (n_cand + 31) // 32
        like_bm = np.zeros((users.size, n_words), dtype=np.uint32)
        with span("eval.like_bitmap"):
            # every like as (row, candidate); ``.at`` applies repeated
            # (row, word) pairs one by one, so duplicate likes are harmless
            lists = [l for l in likes.values() if len(l) > 0]
            lengths = np.fromiter(map(len, lists), np.int64, count=users.size)
            flat = np.fromiter(itertools.chain.from_iterable(lists), np.int64,
                               count=int(lengths.sum()))
            rows = np.repeat(np.arange(users.size), lengths)
            np.bitwise_or.at(like_bm, (rows, flat >> 5),
                             np.left_shift(np.uint32(1),
                                           (flat & 31).astype(np.uint32)))
        idx = top_idx[users]                       # [nu, k]
        valid = np.isfinite(top_vals[users])
        words = like_bm[np.arange(users.size)[:, None], idx >> 5]
        hit = (((words >> (idx & 31).astype(np.uint32)) & 1).astype(bool)
               & valid)
        k_eff = idx.shape[1]
        hits = np.zeros(interval)
        for j in range(interval):
            cut = min((j + 1) * step, k_eff)
            hits[j] = hit[:, :cut].sum()
        rrs = np.zeros(interval)
        if seen_above is not None:
            raw = np.arange(k_eff)[None, :] + seen_above[users]  # raw rank t
            rr_vals = np.where(hit, 1.0 / (raw + 1.0), 0.0)
            bucket = raw // step
            for j in range(interval):
                rrs[j] = rr_vals[bucket <= j].sum()
        return EvalResult(hits=hits, rr=rrs, count=count)


def evaluate_scores_device(
    U: np.ndarray,
    V_cand: np.ndarray,
    bias: Optional[np.ndarray],
    seen_bitmap: np.ndarray,
    cand_item_ids: np.ndarray,
    likes: Dict[int, Sequence[int]],
    step: int = 5,
    total: int = 30,
    user_chunk: int = 8192,
    use_kernel: bool = False,
    want_rr: bool = True,
    device="cuda",
) -> EvalResult:
    """End-to-end device evaluation equivalent to ``evaluate_oracle``
    (eval/device.py:288-323); ``want_rr=False`` returns rr as zeros."""
    out = topk_unseen(
        U, V_cand, bias, seen_bitmap, cand_item_ids, total, user_chunk,
        use_kernel, want_raw_rank=want_rr, device=device,
    )
    vals, idx = out[0], out[1]
    seen_above = out[2] if want_rr else None
    return _count_hits(
        idx, vals, seen_above, likes, V_cand.shape[0], step, total
    )


def _notcand_words(n_items: int, cand_item_ids: np.ndarray) -> np.ndarray:
    """uint32 [ceil(n_items/32)] bitmap with 1 for NON-candidate items."""
    n_words = (n_items + 31) // 32
    bits = np.ones(n_words * 32, dtype=np.uint8)
    bits[np.asarray(cand_item_ids, dtype=np.int64)] = 0
    return np.ascontiguousarray(
        np.packbits(bits, bitorder="little")
    ).view("<u4")


def _or_bitmap(seen: torch.Tensor, notcand: torch.Tensor) -> torch.Tensor:
    return seen | notcand[None, :]


def _andnot_bitmap(seen: torch.Tensor, notcand: torch.Tensor) -> torch.Tensor:
    return seen & ~notcand[None, :]


def _topk_excl(U, V, bias, excl_dev, rr_dev, k, user_chunk, use_kernel, dev):
    """Chunked device top-k against a full-space exclusion bitmap, with
    optional raw-rank counting against ``rr_dev`` (eval/device.py:405-453)."""
    return _chunked(
        U, _to_dev(V, dev), _to_dev(bias, dev), excl_dev, rr_dev,
        V.shape[0], k, user_chunk, use_kernel, dev,
    )


def evaluate_scores_device_full(
    U: np.ndarray,
    V: np.ndarray,                 # FULL catalog [n_items, dim]
    bias: Optional[np.ndarray],
    seen_bitmap,                   # full item space, numpy or device int32
    cand_item_ids: np.ndarray,
    likes: Dict[int, Sequence[int]],
    step: int = 5,
    total: int = 30,
    user_chunk: int = 8192,
    use_kernel: bool = False,
    want_rr: bool = True,
    device="cuda",
) -> EvalResult:
    """Full-item-space evaluation (eval/device.py:336-392): every item is
    scored and seen-or-non-candidate items are excluded through ONE bitmap,
    seen | notcand, built on the device; returned item indices map back to
    candidate positions on the host."""
    dev = resolve_device(device)
    n_items = V.shape[0]
    cand = np.asarray(cand_item_ids, dtype=np.int64)
    k = min(total, len(cand))
    seen_dev = (
        seen_bitmap.to(dev)
        if isinstance(seen_bitmap, torch.Tensor)
        else bitmap_tensor(seen_bitmap, dev)
    )
    nc_dev = bitmap_tensor(_notcand_words(n_items, cand), dev)
    excl = _or_bitmap(seen_dev, nc_dev)
    # raw rank counts SEEN CANDIDATES ranked above (the reference walks the
    # candidate list only, evaluate.py:95-97): seen AND NOT notcand
    rr = _andnot_bitmap(seen_dev, nc_dev) if want_rr else None
    out = _topk_excl(U, V, bias, excl, rr, k, user_chunk, use_kernel, dev)
    vals, idx = out[0], out[1]
    seen_above = out[2] if want_rr else None
    inv = np.full(n_items, 0, dtype=np.int32)
    inv[cand] = np.arange(len(cand), dtype=np.int32)
    idx = inv[np.clip(idx, 0, n_items - 1)]
    return _count_hits(idx, vals, seen_above, likes, len(cand), step, total)


class DeviceEvaluator:
    """Reusable evaluator bound to one fold's history (eval/device.py:456).

    The device copy of the seen bitmap is shared across scenarios and keyed
    on the source array: assigning a new ``seen_bitmap`` re-ships it (the
    JAX class keeps the first copy forever, eval/device.py:478,489-492).
    An array changed in place is not detected; assign a new one.
    """

    def __init__(
        self,
        seen_bitmap: np.ndarray,
        step: int = 5,
        total: int = 30,
        user_chunk: int = 8192,
        use_kernel: bool = False,
        want_rr: bool = True,
        device="cuda",
    ):
        self.seen_bitmap = seen_bitmap
        self.step = step
        self.total = total
        self.user_chunk = user_chunk
        self.use_kernel = use_kernel
        self.want_rr = want_rr
        self.device = resolve_device(device)
        self._seen_src = None
        self._seen_dev = None

    def _seen_on_device(self) -> torch.Tensor:
        if self._seen_src is not self.seen_bitmap:
            self._seen_dev = bitmap_tensor(self.seen_bitmap, self.device)
            self._seen_src = self.seen_bitmap
        return self._seen_dev

    def evaluate(
        self,
        U: np.ndarray,
        V: np.ndarray,
        bias: Optional[np.ndarray],
        cand_item_ids: np.ndarray,
        likes: Dict[int, Sequence[int]],
    ) -> EvalResult:
        return evaluate_scores_device_full(
            U,
            V,
            bias.reshape(-1) if bias is not None else None,
            self._seen_on_device(),
            np.asarray(cand_item_ids),
            likes,
            self.step,
            self.total,
            self.user_chunk,
            self.use_kernel,
            self.want_rr,
            self.device,
        )
