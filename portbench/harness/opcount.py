"""Operations and bytes of the program's work, and the H100's peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W):
67 TFLOP/s in float32 outside the tensor cores, 989 TFLOP/s in bf16 on
them, 3.35 TB/s of HBM3.

Kernel K1 (``csrc/topk_fused.cu``: ``topk_pass1`` and ``topk_merge``), one
call on ``n_u`` user rows against ``n_i`` items of width ``d``, keeping
``k`` per row:

    flops = 2 · n_u · n_i · d
    bytes = e · d · (n_u + n_i)        U and V at their real width, read once
          + 4 · n_i                    the fp32 item bias
          + 4 · n_u · ceil(n_i / 32)   the exclusion bit words
          + 8 · n_u · k                the values and ids written once
    bound = max(flops / peak, bytes / 3.35e12)

with ``e`` = 4 and the fp32 peak in the exact mode (evaluation), ``e`` = 2
and the bf16 peak in the serving mode. The items counted are the ones the
work needs: all of them in serving, a scenario's candidates in
``evaluate``, which hands K1 the whole catalog and excludes the rest by
the bits (work the bound does not count).

Training FLOPs per sample (one triplet), from the losses as the program
writes them (``models/bpr.py`` ``_pairwise_loss``, ``models/vbpr.py``
``_vbpr_loss``), with k the width of a row and l2 regularization:

BPR, rows ``pu`` [k], ``pi``/``pj`` [k + 1] with the bias last:

    forward   x = bi - bj + Σ pu·(pi - pj)         3k + 2
              softplus(-x)                          4
              l2 terms of pu, pi, pj and biases     6k + 8
    backward  gu, gi, gj (σ scale plus l2 term)     9k
              bias gradients                        4
    sum       duplicate rows' gradients             3(k + 1)
    RMSProp   9 per element of the three rows       27(k + 1)
    total     48k + 48                              (2,448 at k = 50)

VBPR, rating rows of width h = k/2 and content rows ``ic``/``jc`` of
width d with the projection ``cem`` [d, h] and ``icb`` [d]:

    the BPR terms at width h (user rows 2h)         48h + 48 + 9h
    ic @ cem, jc @ cem                              4·d·h
    (ic - jc) @ icb                                 3d
    gradient of cem (icᵀ·g and jcᵀ·g)               4·d·h
    gradient of icb                                 2d
    dense RMSProp of cem and icb, per step          9·d·(h + 1) / B
    total     8dh + 5d + 57h + 48 + 9d(h + 1)/B     (4.12 M at d = 20,000,
                                                     h = 25, B = 256)
"""

from __future__ import annotations

import math

PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def k1_flops(n_u: int, n_i: int, d: int) -> float:
    return 2.0 * n_u * n_i * d


def k1_bytes(n_u: int, n_i: int, d: int, k: int, exact: bool) -> float:
    e = 4 if exact else 2
    return (e * d * (n_u + n_i) + 4 * n_i + 4 * n_u * math.ceil(n_i / 32)
            + 8 * n_u * k)


def bound_s(flops: float, n_bytes: float, exact: bool) -> float:
    """The least time the card could take: the larger of the operations
    over their peak and the bytes over the memory rate."""
    return max(flops / (PEAK_FP32 if exact else PEAK_BF16),
               n_bytes / PEAK_BYTES)


def k1_bound_s(n_u: int, n_i: int, d: int, k: int, exact: bool) -> float:
    return bound_s(k1_flops(n_u, n_i, d), k1_bytes(n_u, n_i, d, k, exact),
                   exact)


def bpr_flops_per_sample(k: int) -> float:
    return 48.0 * k + 48.0


def vbpr_flops_per_sample(k: int, d: int, batch: int) -> float:
    h = k // 2
    return (8.0 * d * h + 5.0 * d + 57.0 * h + 48.0
            + 9.0 * d * (h + 1) / batch)


def train_flops_per_sample(cfg: dict, batch: int) -> float:
    if cfg["model"] == "bpr":
        return bpr_flops_per_sample(cfg["k"])
    if cfg["model"] == "vbpr":
        return vbpr_flops_per_sample(cfg["k"], cfg["d"], batch)
    raise ValueError(f"no FLOP count for model {cfg['model']!r}")


def score_flops(n_u: int, n_cand: int, d: int) -> float:
    """The products of scoring ``n_u`` users against ``n_cand`` items."""
    return 2.0 * n_u * n_cand * d
