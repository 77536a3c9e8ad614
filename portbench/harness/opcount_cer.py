"""Operations and bytes of CER's work (``models/cer.py``, ``ops/als.py``),
with the H100's peaks of ``harness/opcount.py``.

A call of ``CER.train`` on a fold of ``pairs`` training pairs, n_u users,
n items, k factors and d features, float32 throughout:

    prologue        G = F·Fᵀ (the Woodbury route, d > n)      2·n²·d
    each iteration  F·E                                       2·n·d·k
      both half-sweeps, per side over its fixed table X:
                    S @ [x xᵀ ‖ x] over the pairs             2·pairs·(k² + k)
                    the rows x xᵀ                             rows·k²
                    b·XᵣᵀXᵣ                                   2·rows·k²
                    a Cholesky and its two triangular
                    solves per entity                         k³/3 + 2k²
      the E-solve:  the first G·X (on X = 0), then each
                    CG step's G·P                             2·n²·k each
                    Fᵀ·X                                      2·n·d·k
                    a direct solve in its place (the
                    fallback): LU and the solve               2n³/3 + 2·n²·k
    write-back      F·E                                       2·n·d·k

The elementwise work (the CG vectors, the fit, the loss) is left out: it
is under 3 % of an iteration's operations.

The E-solve's bound is what the card needs at least for the work done
inside the program's ``cer.esolve`` span, each product at the larger of
its operations over 67 TFLOP/s and its bytes over 3.35 TB/s:

    a G·X product   max(2·n²·k / peak, 4·n² / rate)           G read once
    Fᵀ·X            max(2·n·d·k / peak, 4·(n·d + n·k + d·k) / rate)
    a direct solve  max((2n³/3 + 2·n²·k) / peak, 4·(2n² + 2·n·k) / rate)
"""

from __future__ import annotations

from typing import Sequence

from .opcount import PEAK_BYTES, PEAK_FP32


def _bound(flops: float, n_bytes: float) -> float:
    return max(flops / PEAK_FP32, n_bytes / PEAK_BYTES)


def gram_flops(n: int, d: int) -> float:
    return 2.0 * n * n * d


def sweep_flops(pairs: int, n_users: int, n_items: int, k: int) -> float:
    """Both half-sweeps of one iteration."""
    rows = n_users + n_items  # each side's fixed table, and its entities
    return (2 * 2.0 * pairs * (k * k + k) + 3.0 * rows * k * k
            + rows * (k ** 3 / 3.0 + 2.0 * k * k))


def product_flops(n: int, d: int, k: int) -> float:
    """F·E or Fᵀ·X."""
    return 2.0 * n * d * k


def direct_flops(n: int, k: int) -> float:
    return 2.0 * n ** 3 / 3.0 + 2.0 * n * n * k


def esolve_flops(n: int, d: int, k: int, steps: int, direct: int) -> float:
    """One E-solve on the Woodbury route: ``steps`` CG steps (and the
    first product when CG ran), ``direct`` direct solves, and Fᵀ·X."""
    cg = (steps + 1) * 2.0 * n * n * k if steps else 0.0
    return cg + direct * direct_flops(n, k) + product_flops(n, d, k)


def call_flops(pairs: int, n_users: int, n_items: int, d: int, k: int,
               steps: Sequence[int], direct: Sequence[int]) -> float:
    """One call of ``CER.train`` whose E-solves took ``steps[t]`` CG steps
    and ``direct[t]`` direct solves in iteration t (d > n_items)."""
    per_iter = (product_flops(n_items, d, k)
                + sweep_flops(pairs, n_users, n_items, k))
    return (gram_flops(n_items, d) + product_flops(n_items, d, k)
            + len(steps) * per_iter
            + sum(esolve_flops(n_items, d, k, s, x)
                  for s, x in zip(steps, direct)))


def esolve_bound_s(n: int, d: int, k: int, steps: int, direct: int) -> float:
    """The least time of one E-solve's work (see above)."""
    step = _bound(2.0 * n * n * k, 4.0 * n * n)
    cg = (steps + 1) * step if steps else 0.0
    solve = _bound(direct_flops(n, k), 4.0 * (2 * n * n + 2 * n * k))
    ftx = _bound(product_flops(n, d, k), 4.0 * (n * d + n * k + d * k))
    return cg + direct * solve + ftx
