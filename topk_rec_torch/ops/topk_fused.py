"""K1: fused U·Vᵀ + bias + seen-mask + exact top-k (counterpart of
``topk_rec_tpu/ops/topk_pallas.py``).

``fused_score_topk`` launches the hand-written CUDA kernel
(``csrc/topk_fused.cu``, built by ``ops/_build.py``) for CUDA tensors and
raises if it cannot be built or launched. For CPU tensors it takes its
plain twin ``fused_score_topk_plain``, which is also what the kernel is
checked against on the card. There is no fallback from a CUDA tensor to
the twin.

Unlike the TPU kernel, which reads an int8 [rows x items] mask expanded by
``expand_seen_mask`` (topk_pallas.py:599-614), K1 reads the packed
exclusion bitmap that the callers already hold: bit ``i & 31`` of word
``i >> 5`` (little-endian, ``topk_rec_tpu/data/dataset.py:38-47``), held as
an ``int32`` tensor with the same bits as the uint32 words (torch has no
shifts on uint32 on the CPU; ``(w >> s) & 1`` is right under the
arithmetic shift). Items at or past ``n_items`` are never returned, so
padding bits need not be set.

Result contract (topk_pallas.py:492-528): values descending, lowest item
index first among equal values (``lax.top_k``'s order); slots past the
number of unexcluded items hold ``(NEG_INF, -1)``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..tracing import span

NEG_INF = float(np.finfo(np.float32).min)  # topk_pallas.py:84


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row top-k in ``lax.top_k`` order: value descending, lowest index
    first among ties (``torch.topk`` does not promise the tie order)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def bitmap_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 bit words (numpy) -> int32 tensor with the same bits."""
    arr = np.ascontiguousarray(words)
    if arr.dtype != np.uint32 and arr.dtype != np.int32:
        raise TypeError(f"bitmap words must be uint32/int32, got {arr.dtype}")
    return torch.from_numpy(arr.view(np.int32)).to(device)


def expand_seen_mask(packed: torch.Tensor, n_cand: int) -> torch.Tensor:
    """Unpack int32 bit words [rows, ceil(n_cand/32)] into int8 [rows, n_cand].

    Counterpart of topk_pallas.py:599-614 (repeat + shift, no gathers).
    """
    if packed.dtype != torch.int32:
        raise TypeError(f"packed bitmap must be int32, got {packed.dtype}")
    shift = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed.unsqueeze(-1) >> shift) & 1
    return bits.reshape(packed.shape[0], -1)[:, :n_cand].to(torch.int8)


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`expand_seen_mask`: bool/int [rows, n] -> int32
    words [rows, ceil(n/32)], bit ``c & 31`` of word ``c >> 5``."""
    rows, n = mask.shape
    n_words = (n + 31) // 32
    bits = torch.zeros((rows, n_words * 32), dtype=torch.int64,
                       device=mask.device)
    bits[:, :n] = (mask != 0).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << \
        torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (bits.view(rows, n_words, 32) * weights).sum(-1)
    # bit 31 set -> the int32 with the same bits is negative
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def pack_candidate_bitmap(
    seen_bitmap: np.ndarray, cand_item_ids: np.ndarray
) -> np.ndarray:
    """Re-pack the full-item-space seen bitmap into candidate space.

    Carried over from topk_pallas.py:617-653 (host NumPy; its home module
    imports jax): out bit c of user u = seen bit ``cand_item_ids[c]``,
    processed in user-row chunks with ``np.packbits``.
    """
    cand = np.asarray(cand_item_ids, dtype=np.int64)
    n_users = seen_bitmap.shape[0]
    n_cand = cand.shape[0]
    n_words = (n_cand + 31) // 32
    pad = n_words * 32 - n_cand
    word_idx = cand >> 5
    shift = (cand & 31).astype(np.uint32)
    out = np.empty((n_users, n_words), dtype=np.uint32)
    chunk = max(1, (1 << 26) // max(1, n_cand))  # ~256MB working set
    for start in range(0, n_users, chunk):
        stop = min(start + chunk, n_users)
        bits = (
            (seen_bitmap[start:stop, word_idx] >> shift) & 1
        ).astype(np.uint8)
        if pad:
            bits = np.pad(bits, ((0, 0), (0, pad)))
        packed = np.ascontiguousarray(
            np.packbits(bits, axis=1, bitorder="little")
        )
        out[start:stop] = packed.view("<u4")
    return out


def _check_inputs(U, V, bias, excl_bits, k=None):
    """Shapes, dtypes and devices of the kernels' inputs; ``k`` is checked
    against K1's limit unless it is None."""
    if U.dim() != 2 or V.dim() != 2 or U.shape[1] != V.shape[1]:
        raise ValueError(
            f"U [n_u, d] and V [n_i, d] must agree on d: {tuple(U.shape)} "
            f"vs {tuple(V.shape)}"
        )
    n_u, n_i = U.shape[0], V.shape[0]
    if k is not None and not 1 <= k <= 128:
        raise ValueError(f"k must be in [1, 128], got {k}")
    if excl_bits.dtype != torch.int32 or tuple(excl_bits.shape) != (
        n_u, (n_i + 31) // 32
    ):
        raise ValueError(
            f"excl_bits must be int32 [{n_u}, {(n_i + 31) // 32}], got "
            f"{excl_bits.dtype} {tuple(excl_bits.shape)}"
        )
    if bias is not None and bias.numel() != n_i:
        raise ValueError(f"bias must have {n_i} entries, got {bias.numel()}")
    for t in (U, V, excl_bits) + (() if bias is None else (bias,)):
        if t.device != U.device:
            raise ValueError("U, V, bias and excl_bits must share a device")
        if t.dtype not in (torch.float32, torch.bfloat16, torch.int32):
            raise TypeError(f"unsupported dtype {t.dtype}")


def _matmul_inputs(U, V, exact_matmul):
    """fp32 for the exact mode unless both tables are bf16 already (the
    widened bf16 values are the same numbers); bf16 for the serving mode."""
    if not exact_matmul or (U.dtype == V.dtype == torch.bfloat16):
        return U.to(torch.bfloat16), V.to(torch.bfloat16)
    return U.float(), V.float()


def fused_score_topk_plain(
    U: torch.Tensor,
    V: torch.Tensor,
    bias: Optional[torch.Tensor],
    excl_bits: torch.Tensor,
    k: int,
    exact_matmul: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of :func:`fused_score_topk`, same contract.

    Materializes the [n_u, n_i] score matrix; fp32 accumulation (TF32 off,
    ``device.set_fp32_matmul``) on fp32 or bf16-rounded inputs.
    """
    _check_inputs(U, V, bias, excl_bits, k)
    scores = masked_scores(U, V, bias, excl_bits, exact_matmul)
    vals, idx = pad_k(*topk_stable(scores, k), k)
    return vals.contiguous(), drop_excluded(idx, excl_bits)


def masked_scores(U, V, bias, excl_bits, exact_matmul):
    """U·Vᵀ + bias [n_u, n_i] in fp32, excluded items at NEG_INF."""
    Ue, Ve = _matmul_inputs(U, V, exact_matmul)
    scores = Ue.float() @ Ve.float().T
    if bias is not None:
        scores = scores + bias.float().reshape(1, -1)
    mask = expand_seen_mask(excl_bits, V.shape[0]) != 0
    return scores.masked_fill(mask, NEG_INF)


def pad_k(vals, idx, k):
    """Pad [rows, < k] results (k > n_items) to k slots of (NEG_INF, -1)."""
    short = k - vals.shape[1]
    if short > 0:
        vals = torch.nn.functional.pad(vals, (0, short), value=NEG_INF)
        idx = torch.nn.functional.pad(idx, (0, short), value=-1)
    return vals, idx


def drop_excluded(idx, excl_bits):
    """Item indices [rows, k] -> int32, with -1 for every excluded item
    (an empty slot, whose value is NEG_INF) and for -1 itself."""
    live = idx >= 0
    safe = torch.where(live, idx, 0).long()
    word = excl_bits.gather(1, safe >> 5)
    hit = ((word >> (safe & 31)) & 1) != 0
    return torch.where(live & ~hit, idx, -1).to(torch.int32).contiguous()


def item_splits(n_u: int, n_i: int, rows: int, tile: int, slots: int,
                max_splits: int):
    """(split_len, n_splits) for a kernel whose blocks take ``rows`` user
    rows and walk the items in tiles of ``tile``, on a card that holds
    ``slots`` resident blocks (SMs x blocks per SM). The catalog is split
    only when the user rows alone leave slots idle (small serving batches);
    a split is a whole number of tiles, and the splits cover the catalog
    exactly: split_len·(n_splits - 1) < n_i <= split_len·n_splits."""
    n_tiles = -(-n_i // tile)
    row_blocks = -(-n_u // rows)
    n_splits = max(1, min(max_splits, n_tiles, slots // row_blocks))
    split_len = -(-n_tiles // n_splits) * tile
    return split_len, -(-n_i // split_len)


@functools.lru_cache(maxsize=None)
def kernel_geometry(name: str, device_index: int, *args):
    """(rows per block, item tile, resident block slots on the card) of the
    kernel whose library query is ``name``, called with ``args``."""
    import ctypes

    from ._build import check, load_library

    lib = load_library()
    rows, tile, blocks = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        err = getattr(lib, name)(*args, ctypes.byref(rows),
                                 ctypes.byref(tile), ctypes.byref(blocks))
    check(err, name)
    if blocks.value < 1:
        raise RuntimeError(f"{name}{args}: no block fits on an SM")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return rows.value, tile.value, sms * blocks.value


def kernel_width(d: int, exact_matmul: bool = True) -> int:
    """Columns of a [n, d] table as K1 and K2 read it: d rounded up to the
    kernels' step over d, 4 in fp32 (the exact mode) and 16 in bf16, so
    that every row is a whole number of 16-byte copies."""
    step = 4 if exact_matmul else 16
    return -(-d // step) * step


def kernel_table(t: torch.Tensor, exact_matmul: bool = True) -> torch.Tensor:
    """A [n, d] table as K1 and K2 read it: in the matmul mode's type
    (float32 for the exact mode, bf16 for the serving mode), contiguous,
    with rows padded by zero columns to the kernels' step over d (4 in
    fp32, 16 in bf16) and a 16-byte aligned base, so that every row is a
    whole number of 16-byte copies. ``t`` itself when it already is one; a
    zero column leaves every score as it was. Callers that launch a kernel
    more than once on a table hold it in this form."""
    dtype = torch.float32 if exact_matmul else torch.bfloat16
    width = kernel_width(t.shape[1], exact_matmul)
    if (t.dtype == dtype and t.shape[1] == width and t.is_contiguous()
            and t.data_ptr() % 16 == 0):
        return t
    out = torch.zeros((t.shape[0], width), dtype=dtype, device=t.device)
    out[:, :t.shape[1]] = t
    return out


def kernel_checks(lib, U, V, bias, excl_bits):
    """The checks a kernel needs beyond :func:`_check_inputs` (d within the
    library's limit, contiguous operands); returns the bias as the kernels
    read it, contiguous fp32, or None."""
    d = U.shape[1]
    if d > lib.tkr_topk_max_d():
        raise ValueError(f"d = {d} exceeds the kernel's {lib.tkr_topk_max_d()}")
    for name, t in (("U", U), ("V", V), ("excl_bits", excl_bits)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return None if bias is None else bias.float().reshape(-1).contiguous()


def kernel_operands(lib, U, V, bias, excl_bits, exact_matmul):
    """K1's and K2's operands after :func:`kernel_checks`: U and V as
    :func:`kernel_table` makes them (no copy for tables already held so),
    and the fp32 bias or None."""
    b = kernel_checks(lib, U, V, bias, excl_bits)
    exact = exact_matmul and not U.dtype == V.dtype == torch.bfloat16
    return kernel_table(U, exact), kernel_table(V, exact), b


def _launch(U, V, bias, excl_bits, k, exact_matmul):
    import ctypes

    from ._build import check, load_library

    lib = load_library()
    n_u = U.shape[0]
    n_i = V.shape[0]
    Ue, Ve, b = kernel_operands(lib, U, V, bias, excl_bits, exact_matmul)
    d = Ue.shape[1]
    bf16 = int(Ue.dtype == torch.bfloat16)
    dev = U.device
    vals = torch.empty((n_u, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n_u, k), dtype=torch.int32, device=dev)
    if n_u == 0:
        return vals, idx
    rows, tile, slots = kernel_geometry("tkr_topk_geometry", dev.index or 0,
                                        k, d, bf16)
    # the merge pass takes at most 32 splits, one per lane
    split_len, n_splits = item_splits(n_u, n_i, rows, tile, slots, 32)
    if n_splits > 1:
        sv = torch.empty((n_u, n_splits, k), dtype=torch.float32, device=dev)
        si = torch.empty((n_u, n_splits, k), dtype=torch.int32, device=dev)
    else:
        sv = si = None
    stream = torch.cuda.current_stream(dev).cuda_stream
    p = ctypes.c_void_p
    with torch.cuda.device(dev):
        err = lib.tkr_topk_fused(
            p(Ue.data_ptr()), p(Ve.data_ptr()),
            p(None if b is None else b.data_ptr()), p(excl_bits.data_ptr()),
            p(vals.data_ptr()), p(idx.data_ptr()),
            p(None if sv is None else sv.data_ptr()),
            p(None if si is None else si.data_ptr()),
            n_u, n_i, d, k, excl_bits.shape[1], split_len, n_splits, bf16,
            p(stream),
        )
    check(err, "fused_score_topk kernel launch")
    fused_score_topk.launches += 1
    return vals, idx


def fused_score_topk(
    U: torch.Tensor,
    V: torch.Tensor,
    bias: Optional[torch.Tensor],
    excl_bits: torch.Tensor,
    k: int,
    exact_matmul: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k (values, indices) of U·Vᵀ + bias over unexcluded items.

    Args:
      U: [n_u, d] float32 or bfloat16 user rows.
      V: [n_i, d] float32 or bfloat16 item rows.
      bias: optional [n_i] float32 item bias.
      excl_bits: int32 [n_u, ceil(n_i/32)] bit words; a set bit excludes.
      k: results per row, 1..128.
      exact_matmul: True = fp32 products (eval); False = bf16-rounded
        inputs with fp32 accumulation (serving, the TPU's DEFAULT).

    Returns (vals f32 [n_u, k], idx i32 [n_u, k]); empty slots hold
    (NEG_INF, -1). CUDA tensors run K1 and count one launch in
    ``fused_score_topk.launches``; CPU tensors run the plain twin.
    """
    if U.device.type == "cpu":
        return fused_score_topk_plain(U, V, bias, excl_bits, k, exact_matmul)
    if U.device.type != "cuda":
        raise ValueError(f"unsupported device {U.device}")
    with span("k1.launch"):
        _check_inputs(U, V, bias, excl_bits, k)
        return _launch(U, V, bias, excl_bits, k, exact_matmul)


fused_score_topk.launches = 0
