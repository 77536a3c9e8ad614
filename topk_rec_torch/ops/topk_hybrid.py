"""K2 and the exact "hybrid" top-k (counterpart of
``topk_rec_tpu/ops/topk_hybrid.py``).

``exact_topk_hybrid`` makes an approximate selector exact, in three passes
(topk_hybrid.py:165-238):

  pass A  score the rows (excluded items -> NEG_INF) and take the
          approximate top-(k + k_extra) with :func:`approx_topk`, sorted by
          value descending, then index ascending; t = the k-th value;
  pass B  K2 (:func:`count_vs_threshold`, CUDA source
          ``csrc/topk_count.cu``) recomputes the scores tile by tile and
          counts, per row, the items above t + eps and within eps of t;
  pass C  rows whose counts do not match the selected top-k are re-ranked
          exactly (:func:`topk_stable`) in rounds of ``cap`` rows.

Why the audit proves a row exact, and why eps scales with each element, is
set out in the JAX module's docstring (topk_hybrid.py:20-34). The result
equals ``lax.top_k`` over the masked scores, ties included; empty slots
hold ``(NEG_INF, -1)``, the contract of ``fused_score_topk``.

Deliberate differences from the JAX package:
- K2 counts only the real items (< n_items). JAX pads the catalog with
  masked columns, which enter the eq count when t is NEG_INF; such a row
  fails the audit either way.
- The bad rows are found with ``nonzero``: one host sync per call. JAX
  stays on the device with a ``while_loop``.
- Pass C re-ranks rows of pass A's score matrix, which the port keeps; JAX
  scores them again. The two are the same numbers.
- ``approx_topk`` is plain PyTorch: JAX computes ``approx_max_k`` outside
  any Pallas kernel.

``count_vs_threshold`` launches K2 for CUDA tensors, counts the launch in
``count_vs_threshold.launches`` and raises if the kernel cannot be built or
launched. For CPU tensors it runs its plain twin
:func:`count_vs_threshold_plain`. There is no fallback from a CUDA tensor
to the twin.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .topk_fused import (
    _check_inputs,
    drop_excluded,
    item_splits,
    kernel_geometry,
    kernel_operands,
    masked_scores,
    pad_k,
    topk_stable,
)

_LANES = 128  # XLA's tiling of the reduced axis of a rank-2 approx_max_k


def approx_bins(n: int, k: int, recall: float) -> Tuple[int, int]:
    """(bins, log2 of the reduction) of ``approx_max_k`` on rows of ``n``.

    The same numbers as XLA's ``approx_top_k_reduction_output_size(n, 2,
    k, recall, False, -1)``. A reduction by 2**m puts 2**m items in each of
    the bins; m is the largest that keeps the expected recall of the top-k,
    exp((1 - k) / window) with window = n / 2**m, at ``recall``, where the
    window is at least 128 and the bins are a multiple of 128. For k = 1
    the bin maxima hold the row's maximum whatever m is, so m is as large
    as the 128-multiple allows, even at recall 1.
    """
    if not 0.0 < recall:
        raise ValueError(f"recall must be in (0, 1], got {recall}")
    if n <= _LANES or (recall >= 1.0 and k > 1):
        return n, 0
    tiles = -(-n // _LANES)
    cap = (tiles - 1).bit_length()  # ceil(log2(tiles))
    if k == 1:
        log2 = cap
    else:
        window = min(max(int((1.0 - k) / math.log(recall)), _LANES), n)
        log2 = min((n // window).bit_length() - 1, cap)
        if log2 == 0:
            return n, 0
    return -(-tiles // (1 << log2)) * _LANES, log2


def approx_topk(
    scores: torch.Tensor, k: int, recall: float = 0.95
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate row top-k: the counterpart of ``jax.lax.approx_max_k``
    with ``aggregate_to_topk=True`` (arXiv:2206.14286).

    The row is padded to bins x 2**m with -inf and viewed as [rows, 2**m,
    bins], so bin b holds items b + j·bins; each bin keeps its maximum
    (the lowest item among equal ones), and the result is the exact top-k
    of the bin maxima in ``lax.top_k`` order. Two of the top-k that share a
    bin lose one of them. Rows short enough that XLA does not reduce them
    (and any row with fewer bins than k) are ranked exactly.

    Returns (values [rows, k], item indices int64 [rows, k]).
    """
    n = scores.shape[1]
    bins, log2 = approx_bins(n, k, recall)
    if log2 == 0 or bins < k:
        return topk_stable(scores, k)
    width = bins << log2
    x = torch.nn.functional.pad(scores, (0, width - n), value=-math.inf)
    x = x.view(scores.shape[0], 1 << log2, bins)
    j = x.argmax(dim=1)  # the first maximum: the lowest item of the bin
    best = x.gather(1, j.unsqueeze(1)).squeeze(1)
    vals, b = topk_stable(best, k)
    return vals, b + j.gather(1, b) * bins


def _counts(s: torch.Tensor, t: torch.Tensor):
    """(#{s > t + eps}, #{|s - t| <= eps}) per row, int32, with
    eps = 1e-4·max(|t|, |s|) + 1e-6 per element (topk_hybrid.py:93-97)."""
    tc = t.float().unsqueeze(1)
    eps = torch.maximum(tc.abs(), s.abs()) * 1e-4 + 1e-6
    gt = (s > tc + eps).sum(1, dtype=torch.int32)
    eq = ((s - tc).abs() <= eps).sum(1, dtype=torch.int32)
    return gt, eq


def _check_t(U, t):
    if t.dtype != torch.float32 or tuple(t.shape) != (U.shape[0],) or \
            t.device != U.device:
        raise ValueError(
            f"t must be float32 [{U.shape[0]}] on {U.device}, got {t.dtype} "
            f"{tuple(t.shape)} on {t.device}"
        )


def count_vs_threshold_plain(
    U: torch.Tensor,
    V: torch.Tensor,
    bias: Optional[torch.Tensor],
    excl_bits: torch.Tensor,
    t: torch.Tensor,
    exact_matmul: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`count_vs_threshold`, same contract:
    materializes the scores and counts by the same formula."""
    _check_inputs(U, V, bias, excl_bits)
    _check_t(U, t)
    return _counts(masked_scores(U, V, bias, excl_bits, exact_matmul), t)


def _launch_count(U, V, bias, excl_bits, t, exact_matmul):
    import ctypes

    from ._build import check, load_library

    lib = load_library()
    n_u = U.shape[0]
    n_i = V.shape[0]
    Ue, Ve, b = kernel_operands(lib, U, V, bias, excl_bits, exact_matmul)
    d = Ue.shape[1]
    bf16 = int(Ue.dtype == torch.bfloat16)
    tt = t.contiguous()
    dev = U.device
    gt = torch.zeros(n_u, dtype=torch.int32, device=dev)
    eq = torch.zeros(n_u, dtype=torch.int32, device=dev)
    if n_u == 0:
        return gt, eq
    # the splits meet in the kernel's atomics: no limit from a merge pass
    rows, tile, slots = kernel_geometry("tkr_count_geometry", dev.index or 0,
                                        d, bf16)
    split_len, n_splits = item_splits(n_u, n_i, rows, tile, slots, 65535)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = lib.tkr_count_vs_threshold(
            p(Ue.data_ptr()), p(Ve.data_ptr()),
            p(None if b is None else b.data_ptr()), p(excl_bits.data_ptr()),
            p(tt.data_ptr()), p(gt.data_ptr()), p(eq.data_ptr()),
            n_u, n_i, d, excl_bits.shape[1], split_len, n_splits, bf16,
            p(stream),
        )
    check(err, "count_vs_threshold kernel launch")
    count_vs_threshold.launches += 1
    return gt, eq


def count_vs_threshold(
    U: torch.Tensor,
    V: torch.Tensor,
    bias: Optional[torch.Tensor],
    excl_bits: torch.Tensor,
    t: torch.Tensor,
    exact_matmul: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (#{s > t + eps}, #{|s - t| <= eps}) of s = U·Vᵀ + bias, with
    excluded items at NEG_INF and eps = 1e-4·max(|t|, |s|) + 1e-6; the
    scores are never stored.

    Args:
      U: [n_u, d] float32 or bfloat16 user rows.
      V: [n_i, d] float32 or bfloat16 item rows.
      bias: optional [n_i] float32 item bias.
      excl_bits: int32 [n_u, ceil(n_i/32)] bit words; a set bit excludes.
      t: float32 [n_u] thresholds.
      exact_matmul: True = fp32 products; False = bf16-rounded inputs with
        fp32 accumulation (serving).

    Returns (gt, eq), int32 [n_u] each, over the n_i real items. CUDA
    tensors run K2 and count one launch in ``count_vs_threshold.launches``;
    CPU tensors run the plain twin.
    """
    if U.device.type == "cpu":
        return count_vs_threshold_plain(U, V, bias, excl_bits, t,
                                        exact_matmul)
    if U.device.type != "cuda":
        raise ValueError(f"unsupported device {U.device}")
    _check_inputs(U, V, bias, excl_bits)
    _check_t(U, t)
    return _launch_count(U, V, bias, excl_bits, t, exact_matmul)


count_vs_threshold.launches = 0


def exact_topk_hybrid(
    U: torch.Tensor,
    V: torch.Tensor,
    bias: Optional[torch.Tensor],
    excl_bits: torch.Tensor,
    k: int,
    k_extra: int = 20,
    cap: int = 2048,
    recall: float = 0.95,
    exact_matmul: bool = True,
    with_stats: bool = False,
):
    """Exact top-k (values, indices) of U·Vᵀ + bias over unexcluded items.

    Same arguments as :func:`fused_score_topk` (any k >= 1), plus the
    oversampling ``k_extra``, the repair round size ``cap`` and the
    selector's ``recall``. Returns (vals f32 [n_u, k], idx i32 [n_u, k]),
    equal to ``lax.top_k`` of the masked scores; empty slots hold
    (NEG_INF, -1). ``with_stats`` also returns the number of repaired rows.
    Makes one host sync (see the module docstring).
    """
    _check_inputs(U, V, bias, excl_bits)
    if k < 1 or cap < 1 or k_extra < 0:
        raise ValueError(f"need k >= 1, cap >= 1, k_extra >= 0: {k}, {cap}, "
                         f"{k_extra}")
    n_i = V.shape[0]
    # pass A: score, approximate top-(k + k_extra), two-key sort
    scores = masked_scores(U, V, bias, excl_bits, exact_matmul)
    v0, i0 = approx_topk(scores, min(k + k_extra, n_i), recall)
    i0, order = torch.sort(i0, dim=1)
    vals, order = torch.sort(v0.gather(1, order), dim=1, descending=True,
                             stable=True)
    vals, idx = pad_k(vals[:, :k].contiguous(), i0.gather(1, order)[:, :k],
                      k)
    t = vals[:, k - 1].contiguous()

    # pass B: the audit (K2 on the card)
    cnt_gt, cnt_eq = count_vs_threshold(U, V, bias, excl_bits, t,
                                        exact_matmul)
    g_have, _ = _counts(vals, t)
    bad = (cnt_gt != g_have) | (cnt_eq != k - g_have)

    # pass C: exact re-rank of the failing rows (the one host sync)
    rows = bad.nonzero().squeeze(1)
    n_bad = int(rows.numel())
    for lo in range(0, n_bad, cap):
        r = rows[lo:lo + cap]
        fv, fi = pad_k(*topk_stable(scores[r], k), k)
        vals[r] = fv
        idx[r] = fi

    idx = drop_excluded(idx, excl_bits)
    if with_stats:
        return vals, idx, n_bad
    return vals, idx
