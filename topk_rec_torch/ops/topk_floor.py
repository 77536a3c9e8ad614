"""P1: the floor of K1, a running max per item residue mod 128 (counterpart
of the probe kernel in ``benchmarks/probe_topk_floor.py:43-83``).

For each user row u and residue l in [0, 128), ``topk_floor`` returns the
max of U[u]·V[i] + bias[i] over the unmasked items i with i % 128 == l
(the probe's variant A), and with ``with_index=True`` also the item that
holds it (variant B), the lowest index among equal values. A residue with
no unmasked item holds (NEG_INF, -1); items past ``n_items`` count as
masked, as the probe's padding does. The mask is K1's packed int32
exclusion words (``pack_mask``), not the probe's dense int8 mask, so the
kernel reads what K1 reads. Both matmul modes are K1's: fp32 products, or
bf16-rounded inputs with fp32 accumulation (the probe's
``Precision.DEFAULT``).

It selects nothing, so its time on the card is the part of K1's that no
selection algorithm can remove: K1's tile loop (``score_tile_sm90.cuh``)
with a running max per residue in registers, reading a seen bit only for a
score that would raise its max. CUDA tensors launch the hand-written kernel
(``csrc/topk_floor.cu``) on U and V as :func:`kernel_table` makes them (no
copy for tables already held so) and count one launch in
``topk_floor.launches``; CPU tensors run the plain version,
:func:`topk_floor_plain`, which is also what the kernel is checked against
on the card.

The probe's ``make_kernel`` is a closure inside its ``main()``, so no test
calls it; the tests hold the plain version to a NumPy transcription of its
arithmetic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .topk_fused import (
    NEG_INF,
    _check_inputs,
    item_splits,
    kernel_geometry,
    kernel_operands,
    masked_scores,
)

LANES = 128  # residues of the item index (the probe's CH)


def topk_floor_plain(
    U: torch.Tensor,
    V: torch.Tensor,
    bias: Optional[torch.Tensor],
    excl_bits: torch.Tensor,
    exact_matmul: bool = True,
    with_index: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of :func:`topk_floor`, same contract: the
    masked scores, padded to a multiple of 128 items with NEG_INF, viewed
    as [n_u, n/128, 128] and reduced over dim 1."""
    _check_inputs(U, V, bias, excl_bits)
    scores = masked_scores(U, V, bias, excl_bits, exact_matmul)
    n_u, n_i = scores.shape
    scores = torch.nn.functional.pad(scores, (0, (-n_i) % LANES),
                                     value=NEG_INF).view(n_u, -1, LANES)
    vals = scores.amax(1)
    if not with_index:
        return vals, None
    lane = torch.arange(LANES, device=scores.device)
    idx = scores.argmax(1) * LANES + lane  # argmax takes the first max
    return vals, torch.where(vals > NEG_INF, idx, -1).to(torch.int32)


def _launch(U, V, bias, excl_bits, exact_matmul, with_index):
    import ctypes

    from ._build import check, load_library

    lib = load_library()
    n_u = U.shape[0]
    n_i = V.shape[0]
    Ue, Ve, b = kernel_operands(lib, U, V, bias, excl_bits, exact_matmul)
    d = Ue.shape[1]
    bf16 = int(Ue.dtype == torch.bfloat16)
    dev = U.device
    vals = torch.empty((n_u, LANES), dtype=torch.float32, device=dev)
    idx = (torch.empty((n_u, LANES), dtype=torch.int32, device=dev)
           if with_index else None)
    if n_u == 0:
        return vals, idx
    # whole tiles of 128 items, so every split starts on residue 0; the
    # merge pass folds at most 32 splits, as K1's does
    rows, tile, slots = kernel_geometry("tkr_floor_geometry", dev.index or 0,
                                        d, bf16)
    split_len, n_splits = item_splits(n_u, n_i, rows, tile, slots, 32)
    pv = pi = None
    if n_splits > 1:
        pv = torch.empty((n_splits, n_u, LANES), dtype=torch.float32,
                         device=dev)
        if with_index:
            pi = torch.empty((n_splits, n_u, LANES), dtype=torch.int32,
                             device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = ctypes.c_void_p

    def ptr(t):
        return p(None if t is None else t.data_ptr())

    with torch.cuda.device(dev):
        err = lib.tkr_topk_floor(
            ptr(Ue), ptr(Ve), ptr(b), ptr(excl_bits), ptr(vals), ptr(idx),
            ptr(pv), ptr(pi), n_u, n_i, d, excl_bits.shape[1], split_len,
            n_splits, bf16, p(stream),
        )
    check(err, "topk_floor kernel launch")
    topk_floor.launches += 1
    return vals, idx


def topk_floor(
    U: torch.Tensor,
    V: torch.Tensor,
    bias: Optional[torch.Tensor],
    excl_bits: torch.Tensor,
    exact_matmul: bool = True,
    with_index: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-residue max of U·Vᵀ + bias over unmasked items.

    Args:
      U: [n_u, d] float32 or bfloat16 user rows.
      V: [n_i, d] float32 or bfloat16 item rows.
      bias: optional [n_i] float32 item bias.
      excl_bits: int32 [n_u, ceil(n_i/32)] bit words; a set bit masks.
      exact_matmul: True = fp32 products; False = bf16-rounded inputs with
        fp32 accumulation.
      with_index: also return the item of each max (variant B).

    Returns (vals f32 [n_u, 128], idx i32 [n_u, 128] or None); a residue
    with no unmasked item holds (NEG_INF, -1).
    """
    if U.device.type == "cpu":
        return topk_floor_plain(U, V, bias, excl_bits, exact_matmul,
                                with_index)
    if U.device.type != "cuda":
        raise ValueError(f"unsupported device {U.device}")
    _check_inputs(U, V, bias, excl_bits)
    return _launch(U, V, bias, excl_bits, exact_matmul, with_index)


topk_floor.launches = 0
