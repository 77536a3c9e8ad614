"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one result line; any failure raises and exits non-zero
without the final ``ok`` line):

1. identify the card (``nvidia-smi`` name and power limit, torch and CUDA);
2. build the kernels K1 (fused top-k), K2 (threshold count) and P1 (K1's
   floor) from ``topk_rec_torch/csrc`` with nvcc, one process per source,
   then the port's C++ fold parser with g++;
3. compare K1 with its plain PyTorch twin on the card, exact (fp32) and
   serving (bf16) mode, on ragged shapes, no bias, rows with fewer than k
   unseen items, an all-ties row, k = 1 and k = 128 (over catalog splits),
   d = 13, 50, 64, 100 and 1024, scores that rise with the item index, and
   the full-width eval chunk (8,192 users x 10,380 items, d = 50, k = 30).
   At full width, CUDA-event medians of K1 (on tables padded as the
   evaluator and the server hold them), its twin and the library
   composition (``addmm``, ``masked_fill_``, ``topk``), the bound of the
   work and the profiler's device time of K1's passes; in bf16 also the
   call on fp32 tables that the wrapper casts and pads (``cast_ms``).
   Then K1 on rising scores at 8,192;
4. compare K2 with its twin in both modes (ragged, no bias, all ties, rows
   with fewer than k unseen, t from the exact top-k so that ties sit at the
   threshold, d up to 1024, rising scores), and time it, its twin and the
   library composition at 256 and 8,192 users at full width, with the
   bound;
5. compare ``exact_topk_hybrid`` with K1 and K1's twin at 256 and 8,192
   users, at the defaults and at settings that force repairs (k_extra = 0,
   recall = 0.8, cap = 32), printing the repaired rows and its time;
6. drive the main path at the full MovieLens width through
   ``topk_rec_torch.cli.main``: a generated fold of 69,878 users x 10,380
   items in the reference file formats with seeded ``final-U/V/B.dat``
   (d = 50); ``evaluate -sl im om`` with ``--engine kernel`` and ``torch``,
   ``recommend -k 30`` with ``--method kernel``, ``exact``, ``hybrid`` and
   ``approx`` for 256 users. The fold must be read by the port's C++
   parser. K1's launch counter must rise in each kernel
   run and K2's in the hybrid run; the engines must agree, the exact
   methods' recommendations must match a float64 NumPy reference, and the
   approx lists must be valid with a mean recall@30 of at least 0.9. Then
   each method's served-batch time at 256 and 8,192 users, the kernel
   methods also with U and V cast and padded in every batch;
7. "floor": compare P1 (the per-residue running max, the floor of K1)
   with its plain version in both modes and both variants (value only,
   value + index) on a ragged shape, no bias, a fully masked row, all ties
   over catalog splits, fewer items than residues, a served batch of 256
   users (32 splits) and the probe's full shape (69,878 x 10,380, d = 50,
   2 % masked), where its plain version, the library composition (scores
   padded to 128 columns, ``amax`` or ``max`` over each residue) and the
   bound are timed too (P1-A fp32 and bf16, P1-B fp32); then, with the
   counts at 0, the probe itself: CUDA-event medians and device times of
   P1-A, P1-B, K1 at k = 1 and K1 at k = 30 on all 69,878 users in both
   modes, on tables held as ``kernel_table`` makes them, with
   ``k1_minus_p1_ms``, and P1-A fp32 on the raw tables;
8. "train": ``train --model bpr --k 50 --batch-size 256`` for two epochs
   through ``topk_rec_torch.cli.main`` on phase 6's fold (losses finite and
   falling, ``final-U/V/B.dat`` and ``checkpoint.npz`` written), then
   ``evaluate`` of the trained tables with both engines on held-out likes
   drawn from the fold's own zipf law (K1's count must rise; the engines
   must agree; accuracy@30 must beat the untrained tables', ``--epochs
   0``), ``recommend --method kernel`` and ``hybrid`` on the trained tables,
   and training samples/s at batch 256 and 8,192 (CUDA events over whole
   chunks after a warm-up chunk) with the kernel launches per step. Then
   "train_layout", BPR's two table layouts (separate, and the fused
   [n_users + n_items, k + 1] table): one chunk of 128 steps under each
   from the same tables on the same triplets at batch 256 and 8,192
   (equal within rtol 2e-4 / atol 1e-5; the fused table's user bias
   column 0 after every step), ms per step and samples/s of each in
   turns, launches per step and busy share at 256 with the fused chunk's
   copy of the tables, and ``train --batch-size 8192`` through the CLI
   (``auto`` must pick the fused table) with ``evaluate`` of its tables
   through K1 under ``TKR_TIMING=1`` (the phase times printed; accuracy@30
   above the untrained tables');
9. "content": item features at d = 20,000 (``meta.pkl``, word counts that
   encode each item's place in the fold's zipf law) and held-out likes of
   cold items from the same law (``zom``); through
   ``topk_rec_torch.cli.main`` at k = 50, ``train --model vbpr`` (one
   epoch's pairs at batch 256 as two half epochs, lr 0.05, lambda_b
   0.01), ``wmf`` (5 iterations) and ``cer`` (3 iterations, the
   Woodbury E-solve on its Cholesky factor, ``--log-dir`` and
   ``--save-lag 1``), each also untrained; losses finite and falling, the
   model files written, CER's system factored once and its E-solves all on
   the factor; then ``evaluate -sl zp
   zom`` of every table set with ``--engine kernel`` (K1's count must
   rise) and of the trained ones with ``--engine torch`` (the engines
   agree within 2/count); trained beats untrained on zp for all three and
   on zom for VBPR and CER. Then the layers' times: VBPR ms and launches
   per step, one ALS half-sweep per side, CER's Gram and factor and its
   E-solve;
10. "dpm": through ``topk_rec_torch.cli.main`` at k = 50 on phase 9's
   ``meta.pkl`` (d = 20,000), ``train --model dpm`` with the MLP encoder
   (d -> 2000 -> 1000 -> 50, 5 iterations, ``--log-dir``, ``--save-lag 1``)
   and with the SDAE encoder (4 iterations after its three pretraining
   epochs per hidden layer), and the untrained tables (``--max-iter 0``);
   losses finite and the last below the first, the files written;
   ``evaluate -sl zp zom`` of the three table sets through K1 (its count
   must rise) and of the trained ones with ``--engine torch`` (the engines
   agree within 2/count); the trained MLP-DPM beats its untrained tables
   on zp and zom.
   Then one iteration's split by CUDA events (encoder predict, the two
   half-sweeps, the encoder's fit sweep), the fit sweep's steps, launches
   per step and busy share at batch 64 and 1,024, and the SDAE's
   pretraining time per layer-epoch;
11. "fuse": ``fuse --strategy average|rank|error|svm|bpr`` and ``rank
   --p-sweep`` through the CLI over the trained VBPR, WMF, CER (phase 9)
   and MLP-DPM (phase 10) tables, F = 4, on zp and zom: every accuracy
   finite and in [0, 1]; each strategy's wall time, the time of its weight
   fit and its CSV lines. Then the fused evaluation is held to K1:
   ``evaluate_fused`` with average weights against
   ``DeviceEvaluator(use_kernel=True)`` on the concatenated tables
   [w_f·U_f] and [V_f] (d = 200), within 2/count on zp and zom;
12. "mesh": ``topk_rec_torch.parallel`` on a 1 x 1 NCCL mesh (a failed
   NCCL init fails the run) on phase 6's fold and phase 9's features:
   ``TopKServer(mesh=)`` with ``kernel``, ``hybrid`` and ``exact`` on four
   256-user batches, its lists equal to the un-meshed server's, and one
   batch from a sticky lookup capacity of 1 (doubled up to the batch);
   ``train --model bpr --mesh 1x1`` through the CLI and ``evaluate`` of its
   tables through K1 above the untrained ones at accuracy@30 (K1's and
   K2's counts, set to 0 before the meshed serving, must rise); the
   served batch's device time meshed and un-meshed; one chunk of
   ``DistributedBPRTrainer`` (``gspmd`` and ``explicit``, batch 256 and
   8,192, k = 50) and of ``DistributedVBPRTrainer`` (d = 20,000) equal to
   the local chunk on the same triplets (rtol 2e-4 / atol 1e-5), with ms
   and launches per step beside the local chunk's;
   ``DistributedALS.half_sweep`` of each side equal to the local sweep
   (rtol 1e-4); one data-parallel MLP encoder sweep (d = 20,000 -> 2,000
   -> 1,000 -> 50, batch 64) equal to the local one;
   ``distributed_scores_topk`` on 8,192 users; and the host's µs per call
   of each collective.

The line before the last is the kernels' JSON record (per kernel: its
launches on the main path, phase 12's included, max error against its
twin, and ms, plain_ms, library_ms, bound_ms and bound_by at its main
shape); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
N_USERS, N_ITEMS, DIM, TOP_K = 69878, 10380, 50, 30  # bench.py:40, :147
N_OM = 1000          # held-out (cold-start) items: the om candidate list
N_PAIRS = 1_300_000  # drawn training pairs before de-duplication
MIN_PAIRS = 1_000_000  # seen pairs the fold must hold after it
TOL = 1e-5           # value tolerance, relative to max(1, |s|)
PROBE_MASKED = 0.02  # masked share of the floor probe (probe_topk_floor.py:37)
TRAIN_EPOCHS = 2
TRAIN_LR = 0.05      # learns within two epochs; the default 1e-4 does not
CONTENT_D = 20000    # the reference's meta.pkl width (SURVEY.md:87)
CONTENT_K = 50       # the reference's content-model k (SURVEY.md:87)
TOPIC_TOKENS = 200   # words of an item's feature row that encode its place
NOISE_TOKENS = 40    # and words drawn from the whole vocabulary
ALS_ITERS = {"wmf": 5, "cer": 3}
VBPR_LB = 0.01       # without it the item biases take the popularity, and
#                      the content learns only that never-liked (cold) items
#                      lose (CPU rehearsal at 30,000 x 6,000: cold
#                      accuracy@30 0.017 at lambda_b = 0, 0.214 at 0.01)
COUNT_SCALE = 0.04   # rows of norm ~1: on raw counts (norm ~25) VBPR's
#                      loss rises at lr 0.05
CER_LE = 1e4 * COUNT_SCALE ** 2  # the reference's le = 1e4 on raw counts
COLD = "zom"         # scenario: cold items liked by the fold's zipf law


def phase(tag, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_median_ms(fn, reps=15, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timed_ms(fn):
    """(fn(), its CUDA-event time in ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def profiled_kernels(fn):
    """The CUDA kernels torch.profiler records during fn()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


# Published peaks of one H100 SXM (dense, at the full 700 W): float32 outside
# the tensor cores, bf16 on them, and the HBM3 rate.
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def table_bytes(exact, *tables) -> int:
    """Bytes of [n, d] tables at their real width d in the mode's element
    type (4 in fp32, 2 in bf16): what the function must read, not the zero
    columns of the kernels' padded copies."""
    return sum(t.shape[0] * t.shape[1] * (4 if exact else 2) for t in tables)


def bound(flops, n_bytes, bf16):
    """(bound_ms, bound_by): the larger of the operations over the peak
    rate of their type and the bytes (each input read once, each output
    written once) over the memory rate."""
    ops_ms = flops / (PEAK_BF16 if bf16 else PEAK_FP32) * 1e3
    mem_ms = n_bytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= mem_ms else (mem_ms, "bytes")


def library_scores(U, V, b, mask, exact):
    """U·Vᵀ + bias by one library product with the seen items at NEG_INF:
    fp32 (TF32 off) in the exact mode, the serving ``exact`` method's
    arithmetic (serving.py: bf16-rounded tables, fp32 product) otherwise.
    The yardstick of the kernels; the port never calls it."""
    from topk_rec_torch.ops.topk_fused import NEG_INF

    if exact:
        s = torch.addmm(b, U, V.T) if b is not None else U @ V.T
    else:
        s = U.bfloat16().float() @ V.bfloat16().float().T
        if b is not None:
            s = s + b[None, :]
    return s.masked_fill_(mask, NEG_INF)


def k1_library(U, V, b, mask, k, exact):
    return torch.topk(library_scores(U, V, b, mask, exact), k)


def k2_library(U, V, b, mask, t, exact):
    s = library_scores(U, V, b, mask, exact)
    tc = t[:, None]
    eps = torch.maximum(tc.abs(), s.abs()) * 1e-4 + 1e-6
    return (s > tc + eps).sum(1), ((s - tc).abs() <= eps).sum(1)


def p1_library(U, V, b, mask, exact, with_index=False):
    from topk_rec_torch.ops.topk_fused import NEG_INF

    s = library_scores(U, V, b, mask, exact)
    s = torch.nn.functional.pad(s, (0, (-s.shape[1]) % 128), value=NEG_INF)
    s = s.view(s.shape[0], -1, 128)
    return s.max(1) if with_index else s.amax(1)


def compare_topk(got, want):
    """(max value error, index mismatches) of one top-k against another.

    Values must agree within TOL * max(1, |s|). Indices must be equal
    wherever the reference's neighbouring values differ by more than that
    (so no near-tie can swap them) and the slot is not empty.
    """
    from topk_rec_torch.ops.topk_fused import NEG_INF

    gv, gi = got
    wv, wi = want
    tol = TOL * torch.clamp(wv.abs(), min=1.0)
    err = (gv - wv).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"values differ: max error {err.max().item()}")
    clear = wv > NEG_INF
    gaps = (wv[:, 1:] - wv[:, :-1]).abs() > tol[:, 1:]
    clear[:, 1:] &= gaps
    clear[:, :-1] &= gaps
    mism = int(((gi != wi) & clear).sum())
    if mism:
        raise AssertionError(f"{mism} index mismatches on tie-free slots")
    return float(err.max().item()), mism


def make_case(dev, n_u, n_i, d, seed, bias=True, ties=False):
    """Seeded U, V, bias and packed exclusion words on ``dev``. Row 0 has
    five unseen items (fewer than k); row 1 has none excluded; ``ties``
    makes every score of row 0 equal."""
    from topk_rec_torch.ops.topk_fused import pack_mask

    g = torch.Generator(device="cpu").manual_seed(seed)
    U = torch.randn(n_u, d, generator=g)
    V = torch.randn(n_i, d, generator=g)
    if ties:
        U[0] = 1.0
        V[:] = 1.0
    b = torch.randn(n_i, generator=g) if bias else None
    mask = torch.rand(n_u, n_i, generator=g) < 0.2
    mask[0, :] = True
    mask[0, : min(5, n_i)] = False   # row 0: fewer than k unseen
    mask[1, :] = False
    return (U.to(dev), V.to(dev), None if b is None else b.to(dev),
            pack_mask(mask).to(dev))


def rising_case(dev, n_u, n_i, d):
    """Scores that rise with the item index in every row (no bias, nothing
    excluded): every tile beats every row's k-th entry, K1's worst case."""
    U = torch.zeros(n_u, d)
    V = torch.zeros(n_i, d)
    U[:, 0] = 1.0
    V[:, 0] = torch.arange(n_i) / n_i
    return (U.to(dev), V.to(dev), None,
            torch.zeros(n_u, (n_i + 31) // 32, dtype=torch.int32, device=dev))


# (n_u, n_i, d, k, bias, ties); "rise" in place of bias: rising_case
KERNEL_CASES = [
    (37, 301, 13, 8, True, False),      # ragged: n_u, n_i % 32, d % 4
    (130, 1000, 50, 30, False, False),  # no bias
    (5, 4173, 50, 128, True, False),    # k = 128 over a catalog split
    (45, 9000, 50, 128, True, False),   # k = 128, n_u % 64 != 0, splits
    (3, 100, 2, 1, True, False),        # k = 1
    (16, 700, 2, 6, False, True),       # all-ties rows
    (33, 2000, 64, 30, True, False),    # d = 64: one slice, no padding
    (70, 3000, 100, 30, True, False),   # d = 100: slices
    (40, 1500, 1024, 30, True, False),  # d = 1024, the kernels' limit
    (50, 5000, 1024, 128, True, False),  # d = 1024 and k = 128
    (300, 6000, 50, 30, "rise", False),  # rising scores: every tile passes
    (256, N_ITEMS, DIM, TOP_K, True, False),   # serving batch
    (8192, N_ITEMS, DIM, TOP_K, True, False),  # full-width chunk
]


def kernel_cases(dev):
    """Phase 3: K1 against its twin; the full-width shapes also timed, on
    tables held as the evaluator and the server hold them
    (``kernel_table``), beside the twin, the library composition and the
    bound. Returns (max_abs_err, {(n_u, mode): timing fields})."""
    from topk_rec_torch.ops.topk_fused import (
        expand_seen_mask,
        fused_score_topk,
        fused_score_topk_plain,
        kernel_table,
    )

    worst = 0.0
    times = {}
    for n_u, n_i, d, k, bias, ties in KERNEL_CASES:
        if bias == "rise":
            U, V, b, words = rising_case(dev, n_u, n_i, d)
        else:
            U, V, b, words = make_case(dev, n_u, n_i, d, seed=n_u * 7 + n_i,
                                       bias=bias, ties=ties)
        for exact in (True, False):
            got = fused_score_topk(U, V, b, words, k, exact_matmul=exact)
            want = fused_score_topk_plain(U, V, b, words, k,
                                          exact_matmul=exact)
            torch.cuda.synchronize()
            err, mism = compare_topk(got, want)
            if ties:
                if not torch.equal(got[1], want[1]):
                    raise AssertionError("all-ties order differs")
            worst = max(worst, err)
            mode = "fp32" if exact else "bf16"
            fields = dict(n_u=n_u, n_i=n_i, d=d, k=k, mode=mode,
                          max_abs_err=err, mismatches=mism)
            if n_i == N_ITEMS:
                Up, Vp = kernel_table(U, exact), kernel_table(V, exact)
                mask = expand_seen_mask(words, n_i) != 0
                t = dict(
                    ms=cuda_median_ms(lambda: fused_score_topk(
                        Up, Vp, b, words, k, exact_matmul=exact)),
                    plain_ms=cuda_median_ms(lambda: fused_score_topk_plain(
                        U, V, b, words, k, exact_matmul=exact)),
                    library_ms=cuda_median_ms(lambda: k1_library(
                        U, V, b, mask, k, exact)),
                )
                t["bound_ms"], t["bound_by"] = bound(
                    2 * n_u * n_i * d,
                    table_bytes(exact, U, V) + nbytes(b, words, *got),
                    not exact)
                times[(n_u, mode)] = t
                fields.update({n: (f"{v:.4f}" if isinstance(v, float) else v)
                               for n, v in t.items()})
                fields.update(device_us(lambda: fused_score_topk(
                    Up, Vp, b, words, k, exact_matmul=exact)))
                if not exact:  # fp32 tables, cast and padded in the call
                    fields["cast_ms"] = "%.4f" % cuda_median_ms(
                        lambda: fused_score_topk(U, V, b, words, k,
                                                 exact_matmul=False))
            phase("k1_vs_plain", **fields)
    k1_rising(dev)
    return worst, times


def device_us(fn, reps=10):
    """Mean device time per launch of each kernel that ``fn`` launches
    (torch.profiler's CUDA events), keyed by a short kernel name, in us;
    the CUDA-event medians elsewhere also hold the host's dispatch. The
    mean is over the launches the profiler recorded, which in a long run
    may be fewer than ``reps``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"topk_pass1|topk_merge|count_pass|floor_pass|"
                      r"floor_merge", e.key)
        us = getattr(e, "device_time_total", 0)
        if m and us > 0 and e.count > 0:
            out[m.group(0) + "_us"] = f"{us / e.count:.1f}"
    return out or {"device": "not measured"}


def k1_rising(dev):
    """K1 fp32 on the full-width chunk with scores that rise with the item
    index: every tile beats every row's k-th entry, its worst case."""
    from topk_rec_torch.ops.topk_fused import fused_score_topk, kernel_table

    U, V, b, words = rising_case(dev, 8192, N_ITEMS, DIM)
    Up, Vp = kernel_table(U, True), kernel_table(V, True)
    ms = cuda_median_ms(lambda: fused_score_topk(Up, Vp, b, words, TOP_K),
                        reps=5, warmup=1)
    phase("k1_rising", n_u=8192, n_i=N_ITEMS, d=DIM, k=TOP_K, mode="fp32",
          ms=f"{ms:.4f}")


K2_CASES = [  # (n_u, n_i, d, k, bias, ties); "rise": rising_case
    (37, 301, 13, 8, True, False),      # ragged, n_i % 32 != 0
    (130, 1000, 50, 30, False, False),  # no bias
    (16, 700, 2, 6, False, True),       # all-ties rows
    (33, 2000, 64, 30, True, False),    # d = 64
    (70, 3000, 100, 30, True, False),   # d = 100: slices
    (50, 5000, 1024, 128, True, False),  # d = 1024, k = 128
    (300, 6000, 50, 30, "rise", False),  # rising scores
    (256, N_ITEMS, DIM, TOP_K, True, False),   # serving batch
    (8192, N_ITEMS, DIM, TOP_K, True, False),  # full-width chunk
]


def k2_cases(dev):
    """Phase 4: K2 against its twin in both modes, with t from the exact
    top-k (ties at the threshold; t = NEG_INF on row 0, which has fewer
    than k unseen items). A count may differ only by the number of
    elements whose twin score lies within 1e-5·max(1, |s|) of t ± eps,
    where the two summation orders can fall on either side.

    Returns (largest count difference, {(n_u, mode): timing fields}), the
    full-width shapes timed as in phase 3."""
    from topk_rec_torch.ops.topk_fused import (
        expand_seen_mask,
        fused_score_topk_plain,
        kernel_table,
        masked_scores,
    )
    from topk_rec_torch.ops.topk_hybrid import (
        count_vs_threshold,
        count_vs_threshold_plain,
    )

    worst = 0
    times = {}
    for n_u, n_i, d, k, bias, ties in K2_CASES:
        if bias == "rise":
            U, V, b, words = rising_case(dev, n_u, n_i, d)
        else:
            U, V, b, words = make_case(dev, n_u, n_i, d,
                                       seed=n_u * 11 + n_i, bias=bias,
                                       ties=ties)
        for exact in (True, False):
            t = fused_score_topk_plain(U, V, b, words, k, exact)[0][:, k - 1]
            t = t.contiguous()
            got = count_vs_threshold(U, V, b, words, t, exact)
            want = count_vs_threshold_plain(U, V, b, words, t, exact)
            s = masked_scores(U, V, b, words, exact)
            tc = t.unsqueeze(1)
            eps = torch.maximum(tc.abs(), s.abs()) * 1e-4 + 1e-6
            band = TOL * torch.clamp(s.abs(), min=1.0)
            near = (((s - (tc + eps)).abs() <= band)
                    | ((s - (tc - eps)).abs() <= band)).sum(1)
            diff = torch.maximum((got[0] - want[0]).abs(),
                                 (got[1] - want[1]).abs())
            torch.cuda.synchronize()
            if bool((diff > near).any()):
                raise AssertionError(
                    f"K2 counts differ beyond the borderline elements: "
                    f"n_u={n_u} n_i={n_i} exact={exact}")
            if bool((want[0] + want[1] < k).any()):
                raise AssertionError("twin counts below the top-k size")
            worst = max(worst, int(diff.max()))
            mode = "fp32" if exact else "bf16"
            fields = dict(n_u=n_u, n_i=n_i, d=d, k=k, mode=mode,
                          max_count_diff=int(diff.max()),
                          borderline=int(near.sum()),
                          ninf_rows=int((t <= -3.0e38).sum()))
            if n_i == N_ITEMS:
                Up, Vp = kernel_table(U, exact), kernel_table(V, exact)
                mask = expand_seen_mask(words, n_i) != 0
                tm = dict(
                    ms=cuda_median_ms(lambda: count_vs_threshold(
                        Up, Vp, b, words, t, exact)),
                    plain_ms=cuda_median_ms(lambda: count_vs_threshold_plain(
                        U, V, b, words, t, exact)),
                    library_ms=cuda_median_ms(lambda: k2_library(
                        U, V, b, mask, t, exact)),
                )
                tm["bound_ms"], tm["bound_by"] = bound(
                    2 * n_u * n_i * d,
                    table_bytes(exact, U, V) + nbytes(b, words, t, *got),
                    not exact)
                times[(n_u, mode)] = tm
                fields.update({n: (f"{v:.4f}" if isinstance(v, float) else v)
                               for n, v in tm.items()})
                fields.update(device_us(lambda: count_vs_threshold(
                    Up, Vp, b, words, t, exact)))
                if not exact:  # fp32 tables, cast and padded in the call
                    fields["cast_ms"] = "%.4f" % cuda_median_ms(
                        lambda: count_vs_threshold(U, V, b, words, t, False))
            phase("k2_vs_plain", **fields)
    return worst, times


def hybrid_cases(dev):
    """Phase 5: ``exact_topk_hybrid`` against K1 and K1's twin at the
    serving batch and the eval chunk, at the defaults and at settings that
    force repairs. Returns the largest value difference."""
    from topk_rec_torch.ops.topk_fused import (
        fused_score_topk,
        fused_score_topk_plain,
    )
    from topk_rec_torch.ops.topk_hybrid import exact_topk_hybrid

    worst = 0.0
    settings = {"default": {},
                "hostile": dict(k_extra=0, recall=0.8, cap=32)}
    for n_u in (256, 8192):
        U, V, b, words = make_case(dev, n_u, N_ITEMS, DIM, seed=n_u + 5)
        for exact in (True, False):
            k1 = fused_score_topk(U, V, b, words, TOP_K, exact)
            plain = fused_score_topk_plain(U, V, b, words, TOP_K, exact)
            for name, kw in settings.items():
                hv, hi, n_bad = exact_topk_hybrid(
                    U, V, b, words, TOP_K, exact_matmul=exact,
                    with_stats=True, **kw)
                err1, _ = compare_topk((hv, hi), k1)
                err2, _ = compare_topk((hv, hi), plain)
                worst = max(worst, err1, err2)
                ms = cuda_median_ms(lambda: exact_topk_hybrid(
                    U, V, b, words, TOP_K, exact_matmul=exact, **kw),
                    reps=7, warmup=2)
                phase("hybrid_vs_exact", n_u=n_u, mode="fp32" if exact
                      else "bf16", settings=name, n_bad=n_bad,
                      max_abs_err=max(err1, err2), hybrid_ms=f"{ms:.4f}")
    return worst


def probe_case(dev, seed=1):
    """The floor probe's inputs at its full shape, made on the card: U, V
    and bias N(0, 1), 2 % of the (user, item) pairs masked."""
    from topk_rec_torch.ops.topk_fused import pack_mask

    g = torch.Generator(device=dev).manual_seed(seed)
    U = torch.randn(N_USERS, DIM, generator=g, device=dev)
    V = torch.randn(N_ITEMS, DIM, generator=g, device=dev)
    b = torch.randn(N_ITEMS, generator=g, device=dev)
    mask = torch.rand(N_USERS, N_ITEMS, generator=g, device=dev)
    return U, V, b, pack_mask(mask < PROBE_MASKED)


def compare_floor(got, want, U, V, b, words, exact):
    """Max value error of P1 against its plain version. Values must agree
    within TOL * max(1, |v|); indices must be equal wherever the residue's
    best score is clear of its second best by more than that."""
    from topk_rec_torch.ops.topk_floor import LANES
    from topk_rec_torch.ops.topk_fused import NEG_INF, masked_scores

    gv, gi = got
    wv, wi = want
    tol = TOL * torch.clamp(wv.abs(), min=1.0)
    err = (gv - wv).abs()
    if bool((err > tol).any()):
        raise AssertionError(f"P1 values differ: max error {err.max().item()}")
    if wi is None:
        return float(err.max().item()), 0
    s = masked_scores(U, V, b, words, exact)
    n_u, n_i = s.shape
    s = torch.nn.functional.pad(s, (0, (-n_i) % LANES), value=NEG_INF)
    top2 = s.view(n_u, -1, LANES).topk(min(2, s.shape[1] // LANES), dim=1)
    clear = wv > NEG_INF
    if top2.values.shape[1] == 2:
        clear &= (top2.values[:, 0] - top2.values[:, 1]) > tol
    mism = int(((gi != wi) & clear).sum())
    if mism or bool(((gi == -1) != (wi == -1)).any()):
        raise AssertionError(f"P1: {mism} index mismatches on clear residues")
    return float(err.max().item()), mism


# (n_u, n_i, d, bias, ties) of phase 7a; N_USERS: probe_case
FLOOR_CASES = [
    (37, 301, 13, True, False),      # ragged: n_i % 32, n_i % 128 != 0
    (130, 1000, 50, False, False),   # no bias
    (16, 700, 2, False, True),       # all ties, over six catalog splits
    (5, 90, 8, True, False),         # fewer items than residues
    (256, N_ITEMS, DIM, True, False),  # a served batch: 32 catalog splits
    (N_USERS, N_ITEMS, DIM, True, False),  # the probe's full shape
]
# the (mode, variant) pairs of P1 whose plain version, library composition
# and bound are timed at the probe's shape
FLOOR_YARDS = (("fp32", "A"), ("fp32", "B"), ("bf16", "A"))


def floor_cases(dev):
    """Phase 7a: P1 against its plain version, both modes, both variants.
    Returns (max_abs_err, {(mode, variant): {plain_ms, library_ms,
    bound_ms, bound_by}} at the probe's shape)."""
    from topk_rec_torch.ops.topk_floor import topk_floor, topk_floor_plain
    from topk_rec_torch.ops.topk_fused import expand_seen_mask

    worst = 0.0
    yards = {}
    for n_u, n_i, d, bias, ties in FLOOR_CASES:
        if n_u == N_USERS:
            U, V, b, words = probe_case(dev)
        else:
            U, V, b, words = make_case(dev, n_u, n_i, d, seed=n_u * 13 + n_i,
                                       bias=bias, ties=ties)
            words[2] = -1  # row 2: every item masked
        for exact in (True, False):
            for with_index in (False, True):
                got = topk_floor(U, V, b, words, exact, with_index)
                want = topk_floor_plain(U, V, b, words, exact, with_index)
                torch.cuda.synchronize()
                err, mism = compare_floor(got, want, U, V, b, words, exact)
                if ties and with_index and not torch.equal(got[1], want[1]):
                    raise AssertionError("P1 all-ties indices differ")
                if n_u < N_USERS and (
                        not bool((got[0][2] <= -3.0e38).all())
                        or with_index and not bool((got[1][2] == -1).all())):
                    raise AssertionError("P1: the masked row is not empty")
                worst = max(worst, err)
                mode = "fp32" if exact else "bf16"
                variant = "B" if with_index else "A"
                fields = dict(n_u=n_u, n_i=n_i, d=d, mode=mode,
                              variant=variant, max_abs_err=err,
                              mismatches=mism)
                if n_u == N_USERS and (mode, variant) in FLOOR_YARDS:
                    mask = expand_seen_mask(words, n_i) != 0
                    yard = dict(
                        plain_ms=cuda_median_ms(lambda: topk_floor_plain(
                            U, V, b, words, exact, with_index),
                            reps=7, warmup=2),
                        library_ms=cuda_median_ms(lambda: p1_library(
                            U, V, b, mask, exact, with_index),
                            reps=7, warmup=2),
                    )
                    del mask
                    yard["bound_ms"], yard["bound_by"] = bound(
                        2 * n_u * n_i * d,
                        table_bytes(exact, U, V) + nbytes(b, words, *got),
                        not exact)
                    yards[(mode, variant)] = yard
                    fields.update({n: (f"{v:.4f}" if isinstance(v, float)
                                       else v) for n, v in yard.items()})
                phase("floor_vs_plain", **fields)
    return worst, yards


def floor_path(dev):
    """Phase 7b, the probe (probe_topk_floor.py:131-151) with the counts at
    0: medians of P1-A, P1-B, K1 at k = 1 (its variant C) and K1 at k = 30
    on the same 69,878 users, in both modes, all on tables held as
    ``kernel_table`` makes them, so that the comparison is of kernels; the
    profiler's device time of each; ``k1_minus_p1_ms``, K1 at k = 30 less
    P1-A, the cost of K1's selection over all users. Then P1-A fp32 once on
    the raw [n, 50] tables, which the wrapper pads in the call. Returns (P1
    launches, {mode: {"p1_a", "p1_b", "k1_k1", "k1_k30"}: ms})."""
    from topk_rec_torch.ops.topk_floor import topk_floor
    from topk_rec_torch.ops.topk_fused import fused_score_topk, kernel_table

    U, V, b, words = probe_case(dev)
    topk_floor.launches = 0
    out = {}
    for exact in (True, False):
        Up, Vp = kernel_table(U, exact), kernel_table(V, exact)
        calls = {
            "p1_a": lambda: topk_floor(Up, Vp, b, words, exact),
            "p1_b": lambda: topk_floor(Up, Vp, b, words, exact,
                                       with_index=True),
            "k1_k1": lambda: fused_score_topk(Up, Vp, b, words, 1, exact),
            "k1_k30": lambda: fused_score_topk(Up, Vp, b, words, TOP_K,
                                               exact),
        }
        ms = {n: cuda_median_ms(fn) for n, fn in calls.items()}
        fields = {f"{n}_ms": f"{t:.4f}" for n, t in ms.items()}
        fields["k1_minus_p1_ms"] = f"{ms['k1_k30'] - ms['p1_a']:.4f}"
        for n, fn in calls.items():
            fields.update({f"{n}_{k}": v for k, v in device_us(fn).items()})
        if exact:
            fields["p1_a_raw_ms"] = "%.4f" % cuda_median_ms(
                lambda: topk_floor(U, V, b, words, exact))
        out["fp32" if exact else "bf16"] = ms
        phase("floor", users=N_USERS, items=N_ITEMS, d=DIM,
              mode="fp32" if exact else "bf16", **fields)
    return topk_floor.launches, out


def write_dat(path, mat):
    """``final-*.dat``: one row per line, ``%f`` values each followed by a
    space (the reference's text format)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, mat, fmt="%f", delimiter=" ", newline=" \n")


def write_fold(root, seed=0):
    """A fold in the reference formats at full width, plus seeded tables.

    Returns the tables and the (user, item) training pairs, all of which
    count as seen."""
    rng = np.random.default_rng(seed)
    uid = [f"u{i}" for i in range(N_USERS)]
    vid = [f"i{i}" for i in range(N_ITEMS)]
    with open(os.path.join(root, "uid"), "w") as f:
        f.write("\n".join(uid) + "\n")
    with open(os.path.join(root, "vid"), "w") as f:
        f.write("\n".join(vid) + "\n")
    # zipf item popularity as bench.py:147-164; the last N_OM items are
    # held out of training (cold-start candidates)
    n_warm = N_ITEMS - N_OM
    uu = rng.integers(0, N_USERS, size=N_PAIRS).astype(np.int64)
    ii = ((rng.zipf(1.1, size=N_PAIRS) - 1) % n_warm).astype(np.int64)
    key = np.unique(uu * N_ITEMS + ii)
    pu, pi = key // N_ITEMS, key % N_ITEMS
    like = rng.random(pu.size) < 0.8  # the rest are browsed, not liked
    starts = np.searchsorted(pu, np.arange(N_USERS + 1))
    cells = np.char.add(np.char.add(np.array(vid)[pi], ":"),
                        np.where(like, "1", "0"))
    with open(os.path.join(root, "f0tr.txt"), "w") as f:
        for u in range(N_USERS):
            lo, hi = starts[u], starts[u + 1]
            if hi > lo:
                f.write(uid[u] + "," + ",".join(cells[lo:hi]) + "\n")

    # six decimals, so the %f text round-trips to the same float32 values
    U = np.round(rng.normal(size=(N_USERS, DIM)) * 0.3, 6).astype(np.float32)
    V = np.round(rng.normal(size=(N_ITEMS, DIM)) * 0.3, 6).astype(np.float32)
    B = np.round(rng.normal(size=(N_ITEMS, 1)) * 0.1, 6).astype(np.float32)
    mdir = os.path.join(root, "model")
    write_dat(os.path.join(mdir, "final-U.dat"), U)
    write_dat(os.path.join(mdir, "final-V.dat"), V)
    write_dat(os.path.join(mdir, "final-B.dat"), B)

    # test likes: for every 4th user, the two best-scoring of 512 random
    # candidates, so accuracy@k is well above zero
    def likes_file(name, pool):
        users = np.arange(0, N_USERS, 4)
        with open(os.path.join(root, f"f0te.{name}.txt"), "w") as f:
            for lo in range(0, users.size, 4096):
                us = users[lo:lo + 4096]
                cand = pool[rng.integers(0, pool.size, size=(us.size, 512))]
                s = np.einsum("ud,ucd->uc", U[us], V[cand]) + B[cand, 0]
                best = np.take_along_axis(cand, np.argsort(-s, axis=1)[:, :2],
                                          axis=1)
                for u, (a, b) in zip(us, best):
                    f.write(f"{uid[u]},{vid[a]}:1,{vid[b]}:1\n")
        with open(os.path.join(root, f"f0te.{name}.idl"), "w") as f:
            f.write("\n".join(vid[i] for i in pool) + "\n")

    likes_file("im", np.arange(N_ITEMS))
    likes_file("om", np.arange(n_warm, N_ITEMS))
    return U, V, B, pu, pi


def run_cli(argv):
    """topk_rec_torch.cli.main(argv) -> (stdout lines, wall seconds)."""
    from topk_rec_torch.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)  # its results reach the host, so the card is done
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{argv[0]} exited {rc}")
    return buf.getvalue().strip().splitlines(), wall


def parse_recs(lines):
    out = {}
    for line in lines:
        user, *cells = line.split(",")
        out[user] = ([c.split(":")[0] for c in cells],
                     np.array([float(c.split(":")[1]) for c in cells]))
    return out


def main_path(dev, root):
    """Phase 6: evaluate and recommend at full width through the CLI.
    Returns the K1 and K2 launches of the run and the fold's seen pairs."""
    from topk_rec_torch.ops.topk_fused import fused_score_topk
    from topk_rec_torch.ops.topk_hybrid import count_vs_threshold

    t0 = time.perf_counter()
    U, V, B, pu, pi = write_fold(root)
    n_pairs = int(pu.size)
    phase("fold", users=N_USERS, items=N_ITEMS, d=DIM, seen_pairs=n_pairs,
          om_items=N_OM, write_s=f"{time.perf_counter() - t0:.2f}")
    if n_pairs < MIN_PAIRS:
        raise AssertionError(f"only {n_pairs} seen pairs")
    data, model = root, os.path.join(root, "model")
    launches = 0
    csv = {}
    from topk_rec_torch.data import parser
    for engine in ("kernel", "torch"):
        fused_score_topk.launches = 0
        lines, wall = run_cli(["evaluate", "-d", data, "-m", model, "-f", "0",
                               "-sl", "im", "om", "--engine", engine,
                               "--device", str(dev)])
        n = fused_score_topk.launches
        if (engine == "kernel") != (n > 0):
            raise AssertionError(f"evaluate --engine {engine}: {n} launches")
        launches += n
        csv[engine] = lines
        phase("evaluate", engine=engine, wall_s=f"{wall:.3f}", launches=n,
              parser=parser(), csv="|".join(lines))
        if parser() != "native":
            raise AssertionError("the fold was not read by the port's C++ "
                                 "parser")
    # accuracies agree within 2/count per bucket (count = liked items)
    for lk, lt in zip(csv["kernel"], csv["torch"]):
        sk, *ak = lk.split(",")
        st, *at = lt.split(",")
        count = 2 * len(range(0, N_USERS, 4))
        ak, at = np.array(ak, float), np.array(at, float)
        if sk != st or len(ak) != 6 or not np.all(np.abs(ak - at) <= 2 / count):
            raise AssertionError(f"evaluate engines disagree: {lk} vs {lt}")
        if not (np.all(np.isfinite(ak)) and np.all(np.diff(ak) >= 0)
                and 0 < ak[-1] <= 1):
            raise AssertionError(f"implausible accuracies: {lk}")

    users = np.random.default_rng(3).choice(N_USERS, 256, replace=False)
    ufile = os.path.join(root, "users.txt")
    with open(ufile, "w") as f:
        f.write("\n".join(f"u{u}" for u in users) + "\n")
    recs = {}
    count_launches = 0
    for method in ("kernel", "exact", "hybrid", "approx"):
        fused_score_topk.launches = 0
        count_vs_threshold.launches = 0
        lines, wall = run_cli(["recommend", "-d", data, "-m", model, "-f", "0",
                               "-k", str(TOP_K), "--method", method,
                               "--users-file", ufile, "--device", str(dev)])
        n = fused_score_topk.launches
        n2 = count_vs_threshold.launches
        if (method == "kernel") != (n > 0) or (method == "hybrid") != (n2 > 0):
            raise AssertionError(
                f"recommend --method {method}: {n} K1, {n2} K2 launches")
        launches += n
        count_launches += n2
        recs[method] = parse_recs(lines)
        phase("recommend", method=method, users=len(lines),
              wall_s=f"{wall:.3f}", launches_k1=n, launches_k2=n2)

    # reference: float64 scores of the bf16-rounded tables, seen excluded
    Ub = torch.from_numpy(U[users]).bfloat16().double().numpy()
    Vb = torch.from_numpy(V).bfloat16().double().numpy()
    ref = Ub @ Vb.T + B[:, 0][None, :]
    row_of = np.full(N_USERS, -1)
    row_of[users] = np.arange(users.size)
    hit = row_of[pu] >= 0
    ref[row_of[pu[hit]], pi[hit]] = -np.inf
    worst = 0.0
    recall = []
    for row, u in enumerate(users):
        order = np.argsort(-ref[row], kind="stable")[:TOP_K]
        want_items = [f"i{i}" for i in order]
        want_vals = ref[row, order]
        tol = TOL * np.maximum(1.0, np.abs(want_vals))
        clear = np.ones(TOP_K, bool)
        gaps = np.abs(np.diff(want_vals)) > tol[1:]
        clear[1:] &= gaps
        clear[:-1] &= gaps
        for method in ("kernel", "exact", "hybrid"):
            items, vals = recs[method][f"u{u}"]
            # printed with six decimals: allow half a unit of the last
            err = np.abs(vals - want_vals)
            if len(items) != TOP_K or np.any(err > tol + 5e-7):
                raise AssertionError(f"recommend {method} u{u}: values")
            worst = max(worst, float(err.max()))
            bad = [j for j in range(TOP_K)
                   if clear[j] and items[j] != want_items[j]]
            if bad:
                raise AssertionError(f"recommend {method} u{u}: items {bad}")
        # approx: valid (unseen items, their own scores, descending) and
        # close to the exact list
        items, vals = recs["approx"][f"u{u}"]
        ids = np.array([int(i[1:]) for i in items])
        own = ref[row, ids]
        if (len(items) != TOP_K or not np.all(np.isfinite(own))
                or np.any(np.abs(vals - own) >
                          TOL * np.maximum(1.0, np.abs(own)) + 5e-7)
                or np.any(np.diff(vals) > 0)):
            raise AssertionError(f"recommend approx u{u}: invalid list")
        recall.append(len(set(items) & set(want_items)) / TOP_K)
    mean_recall = float(np.mean(recall))
    phase("recommend_check", users=len(users), vs="float64 numpy",
          max_abs_err=worst, approx_recall_at_30=mean_recall)
    if mean_recall < 0.9:
        raise AssertionError(f"approx recall@30 {mean_recall} < 0.9")
    serve_latency(root, dev)
    return launches, count_launches, (pu, pi)


def write_zipf_likes(root, pu, pi, seed=5):
    """Held-out likes ``f0te.zp.txt`` drawn from the fold's own zipf law:
    for every 4th user, two distinct items the user has not seen, over the
    whole catalog (``f0te.zp.idl``). A model that learned the training
    pairs ranks these above random tables."""
    rng = np.random.default_rng(seed)
    n_warm = N_ITEMS - N_OM
    seen = np.sort(pu * N_ITEMS + pi)
    users = np.arange(0, N_USERS, 4)
    cand = (rng.zipf(1.1, size=(users.size, 64)) - 1) % n_warm
    key = users[:, None] * N_ITEMS + cand
    at = np.minimum(np.searchsorted(seen, key), seen.size - 1)
    ok = seen[at] != key
    lines = []
    for u, c, o in zip(users, cand, ok):
        picks = []
        for item, good in zip(c, o):
            if good and item not in picks:
                picks.append(item)
            if len(picks) == 2:
                lines.append(f"u{u},i{picks[0]}:1,i{picks[1]}:1")
                break
    with open(os.path.join(root, "f0te.zp.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "f0te.zp.idl"), "w") as f:
        f.write("\n".join(f"i{i}" for i in range(N_ITEMS)) + "\n")
    return 2 * len(lines)


def train_path(dev, root, pu, pi):
    """Phase 8a: ``train --model bpr`` on the fold, then evaluate and
    recommend the trained tables through the CLI. Returns the K1 and K2
    launches of the run."""
    from topk_rec_torch.ops.topk_fused import fused_score_topk
    from topk_rec_torch.ops.topk_hybrid import count_vs_threshold

    n_likes = write_zipf_likes(root, pu, pi)
    trained, untrained = os.path.join(root, "bpr"), os.path.join(root, "bpr0")
    common = ["train", "--model", "bpr", "-d", root, "--k", str(DIM),
              "--batch-size", "256", "--lr", str(TRAIN_LR), "--device",
              str(dev)]
    fused_score_topk.launches = 0
    count_vs_threshold.launches = 0
    lines, wall = run_cli(common + ["-o", trained, "--epochs",
                                    str(TRAIN_EPOCHS)])
    losses = [float(m.group(1)) for m in
              (re.search(r"Epoch +\d+, loss (\S+),", ln) for ln in lines) if m]
    phase("train", epochs=len(losses), batch=256, lr=TRAIN_LR,
          wall_s=f"{wall:.3f}", losses="|".join(f"{x:.4f}" for x in losses))
    if len(losses) != TRAIN_EPOCHS or not np.all(np.isfinite(losses)) or \
            not np.all(np.diff(losses) < 0):
        raise AssertionError(f"train losses not finite and falling: {losses}")
    for name in ("final-U.dat", "final-V.dat", "final-B.dat",
                 "checkpoint.npz"):
        if not os.path.exists(os.path.join(trained, name)):
            raise AssertionError(f"train wrote no {name}")
    run_cli(common + ["-o", untrained, "--epochs", "0"])

    acc = {}
    for model, engine in ((trained, "kernel"), (trained, "torch"),
                          (untrained, "kernel")):
        before = fused_score_topk.launches
        lines, wall = run_cli(["evaluate", "-d", root, "-m", model, "-f", "0",
                               "-sl", "zp", "--engine", engine, "--device",
                               str(dev)])
        n = fused_score_topk.launches - before
        if (engine == "kernel") != (n > 0):
            raise AssertionError(f"evaluate --engine {engine}: {n} launches")
        acc[(model, engine)] = np.array(lines[0].split(",")[1:], float)
        phase("train_evaluate", model=os.path.basename(model), engine=engine,
              wall_s=f"{wall:.3f}", launches=n, csv=lines[0])
    a_kernel, a_torch = acc[(trained, "kernel")], acc[(trained, "torch")]
    a_base = acc[(untrained, "kernel")]
    if not np.all(np.abs(a_kernel - a_torch) <= 2 / n_likes):
        raise AssertionError(f"engines disagree: {a_kernel} vs {a_torch}")
    if not a_kernel[-1] > a_base[-1]:
        raise AssertionError(
            f"trained accuracy@30 {a_kernel[-1]} <= untrained {a_base[-1]}")
    phase("train_accuracy", likes=n_likes, trained_at_30=a_kernel[-1],
          untrained_at_30=a_base[-1])

    users = np.random.default_rng(6).choice(N_USERS, 256, replace=False)
    ufile = os.path.join(root, "train_users.txt")
    with open(ufile, "w") as f:
        f.write("\n".join(f"u{u}" for u in users) + "\n")
    recs = {}
    for method in ("kernel", "hybrid"):
        k1, k2 = fused_score_topk.launches, count_vs_threshold.launches
        lines, wall = run_cli(["recommend", "-d", root, "-m", trained, "-f",
                               "0", "-k", str(TOP_K), "--method", method,
                               "--users-file", ufile, "--device", str(dev)])
        n1 = fused_score_topk.launches - k1
        n2 = count_vs_threshold.launches - k2
        if ((method == "kernel") != (n1 > 0)
                or (method == "hybrid") != (n2 > 0)):
            raise AssertionError(f"recommend --method {method}: {n1} K1, {n2} "
                                 "K2 launches")
        recs[method] = parse_recs(lines)
        phase("train_recommend", method=method, users=len(lines),
              wall_s=f"{wall:.3f}", launches_k1=n1, launches_k2=n2)
    for u in users:
        (ik, vk), (ih, vh) = recs["kernel"][f"u{u}"], recs["hybrid"][f"u{u}"]
        if len(ik) != TOP_K or np.any(np.abs(vk - vh) > 1e-5):
            raise AssertionError(f"recommend kernel vs hybrid u{u}: values")
        gaps = np.abs(np.diff(vk)) > 1e-5  # printed with six decimals
        clear = np.ones(TOP_K, bool)
        clear[1:] &= gaps
        clear[:-1] &= gaps
        if any(a != b for a, b, c in zip(ik, ih, clear) if c):
            raise AssertionError(f"recommend kernel vs hybrid u{u}: items")
    return fused_score_topk.launches, count_vs_threshold.launches


def train_rate(dev, root):
    """Phase 8b: training samples/s at batch 256 and 8,192 (CUDA events
    over whole chunks of 128 steps after a warm-up chunk), and a profile
    of one chunk at batch 256: kernel launches per step and the device's
    busy share of the chunk."""
    from topk_rec_torch.cli import _load_fold
    from topk_rec_torch.models.bpr import BPR, INIT_STREAM, stream_generator

    inter, _, _ = _load_fold(root, 0)
    model = BPR(k=DIM, lr=TRAIN_LR, device=dev)
    model.set_interactions(inter)
    model._init_params(stream_generator(0, INIT_STREAM, dev))
    steps = 128
    chunk_ms = {}
    for batch, n_chunks in ((256, 4), (8192, 2)):
        gen = stream_generator(0, 0, dev)
        model.train_chunk(gen, steps, batch)  # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_chunks):
            model.train_chunk(gen, steps, batch)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        chunk_ms[batch] = ms / n_chunks
        phase("train_rate", batch=batch, chunks=n_chunks, steps=steps,
              ms_per_step=f"{ms / (n_chunks * steps):.4f}",
              samples_per_s=f"{n_chunks * steps * batch / ms * 1e3:.1f}")

    from torch.profiler import ProfilerActivity, profile

    gen = stream_generator(0, 1, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.train_chunk(gen, steps, 256)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    # one stream, so the kernels do not overlap and their times add up
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    # the profiler slows the host down: the busy share of the unprofiled
    # chunk (its CUDA-event time above) is the one to read
    phase("train_profile", batch=256, steps=steps,
          kernels_per_step=f"{len(kernels) / steps:.1f}",
          device_busy_us=f"{busy_us:.0f}", profiled_wall_us=f"{wall_us:.0f}",
          busy_share=(f"{busy_us / (chunk_ms[256] * 1e3):.4f}" if kernels
                      else "not measured"))


LAYOUT_STEPS = 128  # steps of each chunk of the layout phase
# the order of the timed runs, separate (False) and fused (True) in turns:
# the host's pace drifts within a run
TURNS = (False, True, True, False, True, False, False, True)
SLEEP_CYCLES = 50_000_000  # about 25 ms of the card's clock


def train_layout(dev, root):
    """Phase 8c: BPR's two table layouts at k = 50 on phase 6's fold.

    (a) one chunk of 128 steps under each layout from the same tables on
    the same triplets, at batch 256 and 8,192: equal within rtol 2e-4 /
    atol 1e-5 (``index_add_``'s atomics sum in another order), the fused
    table's user bias column and its accumulator 0 after every step;
    (b) ms per step and samples/s of each layout at both batches (CUDA
    events over whole chunks after a warm-up chunk, the layouts in turns,
    ``TURNS``); (c) launches per step and busy share of each layout at
    batch 256 (torch.profiler), and the fused chunk's copy of the tables
    in and out; (d) ``train --batch-size 8192``
    through the CLI, where ``auto`` must pick the fused table, then
    ``evaluate`` of its tables through K1 with ``TKR_TIMING=1``: its phase
    times, and accuracy@30 above phase 8's untrained tables. Returns K1's
    launches of (d)."""
    from topk_rec_torch.cli import _load_fold
    from topk_rec_torch.models import bpr as tbpr
    from topk_rec_torch.models.bpr import BPR, INIT_STREAM, stream_generator
    from topk_rec_torch.ops.topk_fused import fused_score_topk

    gpu = f'"{gpu_line()}"'
    inter, _, _ = _load_fold(root, 0)
    model = BPR(k=DIM, lr=TRAIN_LR, device=dev)
    model.set_interactions(inter)
    model._init_params(stream_generator(0, INIT_STREAM, dev))
    n_users, n_rows = inter.n_users, inter.n_users + inter.n_items
    steps = LAYOUT_STEPS
    # accumulators of 0.01, as phase 12c: from zero, RMSProp's first step
    # is ±3.16·lr whatever the gradient's size, so a gradient near zero
    # would turn on the order of its sums
    model.tables.load(ms={n: torch.full_like(t, 0.01)
                          for n, t in model.tables.ms().items()})
    params = {n: t.clone() for n, t in model.tables.params().items()}
    ms0 = {n: t.clone() for n, t in model.tables.ms().items()}
    hyper = model.hyper()
    chunks = {"separate": tbpr.run_chunk, "fused": tbpr.run_chunk_fused}

    bias_max = []
    apply = tbpr.apply_planned_rmsprop

    def watched(table, acc, *args):
        out = apply(table, acc, *args)
        if table.shape[0] == n_rows:  # the fused table
            bias_max.append(torch.maximum(table[:n_users, DIM].abs().max(),
                                          acc[:n_users, DIM].abs().max()))
        return out

    for batch in (256, 8192):
        u, i, j = model.sample_chunk(stream_generator(0, 2, dev), steps,
                                     batch)
        got = {}
        tbpr.apply_planned_rmsprop = watched
        try:
            for name, chunk in chunks.items():
                model.tables.load(params, ms0)
                loss = float(chunk(model.tables, u, i, j, hyper, model.mode))
                got[name] = ({n: t.clone() for n, t in
                              model.tables.params().items()},
                             {n: t.clone() for n, t in
                              model.tables.ms().items()}, loss)
        finally:
            tbpr.apply_planned_rmsprop = apply
        (p_s, m_s, l_s), (p_f, m_f, l_f) = got["separate"], got["fused"]
        diffs = {f"{w}{n}": float((a[n] - b[n]).abs().max())
                 for w, a, b in (("", p_f, p_s), ("ms_", m_f, m_s))
                 for n in ("ue", "ie", "ib")}
        bias = float(torch.stack(bias_max).max())
        phase("train_layout_equal", batch=batch, steps=steps,
              loss_separate=f"{l_s:.4f}", loss_fused=f"{l_f:.4f}",
              user_bias_max=bias, fused_updates=len(bias_max), gpu=gpu,
              **{f"max_abs_diff_{n}": f"{d:.3e}" for n, d in diffs.items()})
        if not (chunk_close(p_f, p_s) and chunk_close(m_f, m_s)
                and abs(l_f - l_s) <= 1e-4 * abs(l_s)):
            raise AssertionError(f"batch {batch}: the fused chunk differs "
                                 "from the separate one")
        if bias != 0.0 or len(bias_max) != steps:
            raise AssertionError(f"batch {batch}: the fused table's user "
                                 f"bias column reached {bias}")
        bias_max.clear()
    model.tables.load(params, ms0)

    def timed_chunks(n_chunks, batch, fused, gen):
        torch.cuda.synchronize()
        _, ms = timed_ms(lambda: [model.train_chunk(gen, steps, batch, fused)
                                  for _ in range(n_chunks)])
        return ms

    step_ms = {}
    for batch, n_chunks in ((256, 4), (8192, 2)):
        gen = stream_generator(0, 3, dev)
        for fused in (False, True):
            model.train_chunk(gen, steps, batch, fused)  # warm-up
        ms = {False: [], True: []}
        for fused in TURNS:
            ms[fused].append(timed_chunks(n_chunks, batch, fused, gen))
        for fused in (False, True):
            runs = len(ms[fused])
            per_step = sum(ms[fused]) / (runs * n_chunks * steps)
            if batch == 256:
                step_ms[fused] = per_step
            phase("train_layout_rate", batch=batch,
                  layout="fused" if fused else "separate",
                  chunks=runs * n_chunks, steps=steps,
                  ms_per_step=f"{per_step:.4f}",
                  samples_per_s=f"{batch / per_step * 1e3:.1f}",
                  runs_ms="|".join(f"{t:.3f}" for t in ms[fused]), gpu=gpu)

    # the chunk's copy of both tables and accumulators in and out, once
    # per chunk: its device time by CUDA events while the card works
    # through launches queued behind a sleep (so the host's dispatch is
    # not in it), and the kernels the profiler recorded, a sleep after
    # them. The copy makes 10 launches, but on the card the profiler kept
    # the records of 1 to 10 of them in such a short window
    def copy():
        tbpr.unfuse_tables(model.tables, *tbpr.fuse_tables(model.tables))

    def copy_then_sleep():
        copy()
        torch.cuda._sleep(SLEEP_CYCLES)

    copy()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    _, copy_ms = timed_ms(copy)
    copies = [e for e in profiled_kernels(copy_then_sleep)
              if "spin_kernel" not in e.name]  # _sleep's kernel
    # each buffer read and written on the way in and again on the way out
    moved = 4 * nbytes(*model.tables.buffers())

    gen = stream_generator(0, 4, dev)
    for fused in (False, True):
        model.train_chunk(gen, steps, 256, fused)
        kernels = profiled_kernels(
            lambda: model.train_chunk(gen, steps, 256, fused))
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        fields = {}
        if fused:
            fields = dict(copy_kernels_recorded=len(copies),
                          copy_device_ms=f"{copy_ms:.4f}",
                          copy_moved_mb=f"{moved / 1e6:.1f}")
        # the profiler slows the host down: the busy share is that of the
        # unprofiled chunk timed in (b)
        phase("train_layout_profile", batch=256,
              layout="fused" if fused else "separate", steps=steps,
              kernels_per_step=f"{len(kernels) / steps:.1f}",
              device_busy_us=f"{busy_us:.0f}",
              busy_share=f"{busy_us / (step_ms[fused] * steps * 1e3):.4f}",
              gpu=gpu, **fields)
    del model

    out = os.path.join(root, "bpr8192")
    lines, wall = run_cli(["train", "--model", "bpr", "-d", root, "-o", out,
                           "--k", str(DIM), "--batch-size", "8192", "--lr",
                           str(TRAIN_LR), "--epochs", str(TRAIN_EPOCHS),
                           "--device", str(dev)])
    ran = [m.group(1) for m in (re.search(r"on \S+, (\w+) tables", ln)
                                for ln in lines) if m]
    losses = [float(m.group(1)) for m in (EPOCH_RE.search(ln)
                                          for ln in lines) if m]
    phase("train_layout_cli", batch=8192, epochs=len(losses),
          layout=ran[0] if ran else "not printed", wall_s=f"{wall:.3f}",
          losses="|".join(f"{x:.4f}" for x in losses), gpu=gpu)
    if ran != ["fused"]:
        raise AssertionError(f"train --batch-size 8192 ran {ran}, not the "
                             "fused table")
    if len(losses) != TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"train losses not finite: {losses}")

    fused_score_topk.launches = 0
    acc = {}
    for model_dir in (out, os.path.join(root, "bpr0")):
        err = io.StringIO()
        os.environ["TKR_TIMING"] = "1"
        try:
            with contextlib.redirect_stderr(err):
                lines, wall = run_cli(["evaluate", "-d", root, "-m",
                                       model_dir, "-f", "0", "-sl", "zp",
                                       "--engine", "kernel", "--device",
                                       str(dev)])
        finally:
            os.environ.pop("TKR_TIMING")
        times = dict(ln.split()[1:3] for ln in err.getvalue().splitlines()
                     if ln.startswith("timing: "))
        if list(times) != ["fold_parse", "dat_parse", "zp_inputs",
                           "zp_eval", "total"]:
            raise AssertionError(f"evaluate TKR_TIMING=1 printed {times}")
        acc[model_dir] = np.array(lines[0].split(",")[1:], float)
        phase("train_layout_evaluate", model=os.path.basename(model_dir),
              wall_s=f"{wall:.3f}", csv=lines[0], gpu=gpu,
              **{f"timing_{n}": t for n, t in times.items()})
    launches = fused_score_topk.launches
    trained, base = acc[out][-1], acc[os.path.join(root, "bpr0")][-1]
    phase("train_layout_accuracy", batch=8192, trained_at_30=trained,
          untrained_at_30=base, k1_launches=launches, gpu=gpu)
    if launches <= 0:
        raise AssertionError("the fused layout's tables never went through "
                             "K1")
    if not trained > base:
        raise AssertionError(f"trained accuracy@30 {trained} <= untrained "
                             f"{base}")
    return launches


def serve_latency(root, dev):
    """CUDA-event medians of one served batch per method (the device time
    of ``recommend_async``; ``hybrid`` includes its host sync) at 256 and
    8,192 users, on the fold and tables as ``recommend`` loads them; the
    kernel methods also without the server's padded bf16 tables, so that
    the wrapper casts and pads U and V in every batch (``*_cast_ms``)."""
    from topk_rec_torch.cli import _load_fold, _read_model
    from topk_rec_torch.serving import METHODS, TopKServer

    inter, uids, iids = _load_fold(root, 0)
    U, V, B = _read_model(os.path.join(root, "model"), uids, iids)
    srv = TopKServer(U, V, B, inter, device=dev)
    held = srv.U_kernel, srv.V_kernel
    rng = np.random.default_rng(4)
    for n in (256, 8192):
        uids = rng.choice(N_USERS, n, replace=False)
        ms = {}
        for m in METHODS:
            ms[m] = cuda_median_ms(lambda: srv.recommend_async(uids, TOP_K, m))
            if m in ("kernel", "hybrid"):
                srv.U_kernel = srv.V_kernel = None
                ms[m + "_cast"] = cuda_median_ms(
                    lambda: srv.recommend_async(uids, TOP_K, m))
                srv.U_kernel, srv.V_kernel = held
        phase("serve_latency", users=n,
              **{f"{m}_ms": f"{t:.4f}" for m, t in ms.items()})


def write_content(root, seed=7):
    """``meta.pkl``: item features [N_ITEMS, CONTENT_D] in vid order, a
    pickled scipy CSR matrix of word counts, as ``load_features`` reads it.
    Each row is a noisy projection of the item's place in the fold's zipf
    law, x = log10(1 + rank) with the rank taken within its group (warm
    items 0 .. n_warm - 1, cold items n_warm ..), onto hat functions at the
    integers: topic t owns words 100·t .. 100·t + 99, and each of an
    item's TOPIC_TOKENS topic words comes from topic floor(x) with
    probability 1 - frac(x), else from the next; NOISE_TOKENS more come
    from the whole vocabulary. The counts are scaled by COUNT_SCALE.
    Returns the dense float32 matrix."""
    import scipy.sparse as ss

    rng = np.random.default_rng(seed)
    n_warm = N_ITEMS - N_OM
    rank = np.concatenate([np.arange(n_warm), np.arange(N_OM)])
    x = np.log10(1 + rank)
    lo = np.floor(x).astype(np.int64)
    topic = lo[:, None] + (rng.random((N_ITEMS, TOPIC_TOKENS))
                           < (x - lo)[:, None])
    words = np.concatenate([
        topic * 100 + rng.integers(0, 100, size=topic.shape),
        rng.integers(0, CONTENT_D, size=(N_ITEMS, NOISE_TOKENS)),
    ], 1)
    rows = np.repeat(np.arange(N_ITEMS), words.shape[1])
    feat = ss.csr_matrix((np.full(words.size, COUNT_SCALE, np.float32),
                          (rows, words.reshape(-1))),
                         shape=(N_ITEMS, CONTENT_D))  # sums repeated words
    with open(os.path.join(root, "meta.pkl"), "wb") as f:
        pickle.dump(feat, f, protocol=4)
    return feat.toarray()


def write_cold_likes(root, seed=8):
    """Held-out likes of cold items, ``f0te.zom.txt``, drawn from the
    fold's zipf law within the cold group: for every 4th user, two distinct
    items n_warm + (zipf(1.1) - 1) mod N_OM. Returns the number of likes."""
    rng = np.random.default_rng(seed)
    n_warm = N_ITEMS - N_OM
    users = np.arange(0, N_USERS, 4)
    cand = n_warm + (rng.zipf(1.1, size=(users.size, 32)) - 1) % N_OM
    lines = []
    for u, c in zip(users, cand):
        picks = list(dict.fromkeys(c.tolist()))[:2]
        if len(picks) == 2:
            lines.append(f"u{u},i{picks[0]}:1,i{picks[1]}:1")
    with open(os.path.join(root, f"f0te.{COLD}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, f"f0te.{COLD}.idl"), "w") as f:
        f.write("\n".join(f"i{i}" for i in range(n_warm, N_ITEMS)) + "\n")
    return 2 * len(lines)


@contextlib.contextmanager
def counted(module, *names):
    """Count the calls of ``module``'s functions ``names`` in the block."""
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(module, n) for n in names}

    def wrap(name):
        def call(*args, **kwargs):
            counts[name] += 1
            return saved[name](*args, **kwargs)
        return call

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield counts
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


ITER_RE = re.compile(r"Iter +\d+, loss (\S+),.* time (\S+)s")
EPOCH_RE = re.compile(r"Epoch +\d+, loss (\S+), time (\S+)s")


def content_train(dev, root, n_pos):
    """Phase 9a: ``train --model vbpr|wmf|cer`` at k = 50 through the CLI,
    each trained and untrained. Returns {model: (trained dir, untrained
    dir)}."""
    from topk_rec_torch.models import cer as tcer

    half = n_pos // 2
    content = ["--content", "meta.pkl", "--d", str(CONTENT_D)]
    runs = {  # model: (its training flags, its untrained flags, the cut)
        "vbpr": (content + ["--lr", str(TRAIN_LR), "--lambda-b",
                            str(VBPR_LB), "--batch-size", "256", "--epochs",
                            "2", "--epoch-sample-limit", str(half)],
                 content + ["--epochs", "0"],
                 "one epoch of pairs as 2 halves"),
        "wmf": (["--max-iter", str(ALS_ITERS["wmf"])], ["--max-iter", "0"],
                f"{ALS_ITERS['wmf']} of 200 iterations"),
        "cer": (content + ["--max-iter", str(ALS_ITERS["cer"]), "--als-le",
                           str(CER_LE), "--save-lag", "1", "--log-dir",
                           os.path.join(root, "cer")],
                content + ["--max-iter", "0", "--als-le", str(CER_LE)],
                f"{ALS_ITERS['cer']} of 200 iterations"),
    }
    dirs = {}
    for name, (flags, flags0, cut) in runs.items():
        trained = os.path.join(root, name)
        untrained = os.path.join(root, name + "0")
        common = ["train", "--model", name, "-d", root, "--k",
                  str(CONTENT_K), "--device", str(dev)]
        with counted(tcer, "_woodbury_factor", "_ridge_woodbury_factored",
                     "_ridge_direct", "_ridge_woodbury_direct") as solves:
            lines, wall = run_cli(common + ["-o", trained] + flags)
        hits = [m for m in map((EPOCH_RE if name == "vbpr"
                                else ITER_RE).search, lines) if m]
        losses = [float(m.group(1)) for m in hits]
        want = 2 if name == "vbpr" else ALS_ITERS[name]
        fields = dict(model=name, k=CONTENT_K, wall_s=f"{wall:.3f}",
                      losses="|".join(m.group(1) for m in hits),
                      s_per_iter="|".join(m.group(2) for m in hits),
                      cut=cut.replace(" ", "_"))
        if name == "cer":
            fields.update(e_factors=solves["_woodbury_factor"],
                          e_solves=solves["_ridge_woodbury_factored"],
                          e_solves_direct=solves["_ridge_direct"]
                          + solves["_ridge_woodbury_direct"])
        phase("content_train", **fields)
        if len(losses) != want or not np.all(np.isfinite(losses)) or \
                not np.all(np.diff(losses) < 0):
            raise AssertionError(f"{name}: losses not finite and falling: "
                                 f"{losses}")
        files = {"vbpr": ["final-U.dat", "final-V.dat", "final-B.dat",
                          "checkpoint.npz"],
                 "wmf": ["final-U.dat", "final-V.dat"],
                 "cer": ["final-U.dat", "final-V.dat", "final-E.dat",
                         "state.log", "settings.txt", "0000-U.dat"]}[name]
        for f in files:
            if not os.path.exists(os.path.join(trained, f)):
                raise AssertionError(f"train --model {name} wrote no {f}")
        if name == "cer" and (solves["_woodbury_factor"] != 1
                              or solves["_ridge_woodbury_factored"] != want
                              or fields["e_solves_direct"]):
            raise AssertionError(f"CER left the factored Woodbury path: "
                                 f"{solves}")
        run_cli(common + ["-o", untrained] + flags0)
        dirs[name] = (trained, untrained)
    return dirs


def content_evaluate(dev, root, dirs, counts, tag="content"):
    """Phase 9b (and 10b): ``evaluate -sl zp zom`` of every model's tables,
    trained and untrained, with ``--engine kernel``, and of the trained ones
    with ``--engine torch``. K1's count must rise in every kernel run, the
    engines agree within 2/count, and the trained tables beat the
    untrained on zp (every model) and on zom (all but WMF); a model whose
    untrained dir is None is only evaluated. Returns K1's launches."""
    from topk_rec_torch.ops.topk_fused import fused_score_topk

    fused_score_topk.launches = 0
    for name, (trained, untrained) in dirs.items():
        acc = {}
        runs = [(trained, "kernel"), (trained, "torch")]
        if untrained is not None:
            runs.append((untrained, "kernel"))
        for model, engine in runs:
            before = fused_score_topk.launches
            lines, wall = run_cli(["evaluate", "-d", root, "-m", model, "-f",
                                   "0", "-sl", "zp", COLD, "--engine", engine,
                                   "--device", str(dev)])
            n = fused_score_topk.launches - before
            if (engine == "kernel") != (n > 0):
                raise AssertionError(f"evaluate --engine {engine}: {n} "
                                     "launches")
            acc[(model, engine)] = {ln.split(",")[0]:
                                    np.array(ln.split(",")[1:], float)
                                    for ln in lines}
            phase(f"{tag}_evaluate", model=os.path.basename(model),
                  engine=engine, wall_s=f"{wall:.3f}", launches=n,
                  csv="|".join(lines))
        fields = {}
        for sc, count in counts.items():
            a_k = acc[(trained, "kernel")][sc]
            a_t = acc[(trained, "torch")][sc]
            if not np.all(np.abs(a_k - a_t) <= 2 / count):
                raise AssertionError(f"{name} {sc}: engines disagree: {a_k} "
                                     f"vs {a_t}")
            fields[f"{sc}_trained_at_30"] = a_k[-1]
            if untrained is None:
                continue
            a_0 = acc[(untrained, "kernel")][sc]
            fields[f"{sc}_untrained_at_30"] = a_0[-1]
            if (sc == "zp" or name != "wmf") and not a_k[-1] > a_0[-1]:
                raise AssertionError(
                    f"{name} {sc}: trained accuracy@30 {a_k[-1]} <= "
                    f"untrained {a_0[-1]}")
        phase(f"{tag}_accuracy", model=name, **fields)
    return fused_score_topk.launches


def content_rates(dev, root, feat):
    """Phase 9c: the layers' times on the card. VBPR: CUDA events over
    whole 64-step chunks at batch 256 after a warm-up chunk, and a
    torch.profiler count of launches per step. WMF: one half-sweep of each
    side (the pair sums are a CSR product per block). CER: G = F·Fᵀ with
    the Cholesky factor of le·I + lv·G, then the E-solve on that factor."""
    from topk_rec_torch.cli import _load_fold
    from topk_rec_torch.models import CER, VBPR, WMF
    from topk_rec_torch.models.bpr import INIT_STREAM, stream_generator
    from topk_rec_torch.ops.als import half_sweep

    inter, _, _ = _load_fold(root, 0)
    model = VBPR(k=CONTENT_K, d=CONTENT_D, lr=TRAIN_LR, device=dev)
    model.set_interactions(inter)
    model.set_features(feat)
    model._init_params(stream_generator(0, INIT_STREAM, dev))
    steps, n_chunks = 64, 4
    gen = stream_generator(0, 0, dev)
    model.train_chunk(gen, steps, 256)  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_chunks):
        model.train_chunk(gen, steps, 256)
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / (n_chunks * steps)
    kernels = profiled_kernels(lambda: model.train_chunk(gen, steps, 256))
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    phase("content_vbpr_step", batch=256, d=CONTENT_D, k=CONTENT_K,
          ms_per_step=f"{step_ms:.4f}",
          samples_per_s=f"{256 / step_ms * 1e3:.1f}",
          kernels_per_step=f"{len(kernels) / steps:.1f}",
          busy_share=(f"{busy_us / (step_ms * steps * 1e3):.4f}" if kernels
                      else "not measured"))
    del model

    wmf = WMF(k=CONTENT_K, device=dev)
    wmf.set_interactions(inter)
    t = wmf._device_tables()
    ms = {
        "user": cuda_median_ms(lambda: half_sweep(
            wmf._user_plan, t.U, t.V, wmf._rated_items, wmf.a, wmf.b, wmf.lu,
            as_numpy=False), reps=5, warmup=1),
        "item": cuda_median_ms(lambda: half_sweep(
            wmf._item_plan, t.V, t.U, wmf._rated_users, wmf.a, wmf.b, wmf.lv,
            as_numpy=False), reps=5, warmup=1),
    }
    phase("content_als_sweep", k=CONTENT_K, sums="csr_spmm",
          user_blocks=wmf._user_plan.n_blocks,
          item_blocks=wmf._item_plan.n_blocks,
          **{f"{s}_half_sweep_ms": f"{v:.4f}" for s, v in ms.items()})

    cer = CER(k=CONTENT_K, d=CONTENT_D, le=CER_LE, device=dev)
    cer.set_interactions(inter)
    cer.set_features(feat)
    Y = t.V.clone()
    del wmf, t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    cer._woodbury_system(cer._feat_device())
    end.record()
    end.synchronize()
    gram_ms = start.elapsed_time(end)
    solve_ms = cuda_median_ms(lambda: cer._solve_E(Y), reps=5, warmup=1)
    if cer._e_solver_use_direct or cer._factor is None:
        raise AssertionError("the E-solve left the factored Woodbury path")
    phase("content_e_solve", d=CONTENT_D, n_items=N_ITEMS, k=CONTENT_K,
          route="woodbury_factor", gram_factor_ms=f"{gram_ms:.4f}",
          e_solve_ms=f"{solve_ms:.4f}")


def content_path(dev, root):
    """Phase 9: the content and ALS trainers at k = 50, d = 20000 on phase
    6's fold, then their tables through K1. Returns K1's launches, the
    {model: (trained dir, untrained dir)}, the held-out likes per scenario
    and the features."""
    from topk_rec_torch.cli import _load_fold

    t0 = time.perf_counter()
    feat = write_content(root)
    n_cold = write_cold_likes(root)
    with open(os.path.join(root, "f0te.zp.txt")) as f:
        n_zp = 2 * sum(1 for line in f if line.strip())
    n_pos = _load_fold(root, 0)[0].nnz
    phase("content_data", items=N_ITEMS, d=CONTENT_D,
          feat_mb=feat.nbytes >> 20, zp_likes=n_zp, zom_likes=n_cold,
          liked_pairs=n_pos,
          write_s=f"{time.perf_counter() - t0:.2f}")
    dirs = content_train(dev, root, n_pos)
    counts = {"zp": n_zp, COLD: n_cold}
    launches = content_evaluate(dev, root, dirs, counts)
    content_rates(dev, root, feat)
    phase("content", seconds=f"{time.perf_counter() - t0:.2f}",
          k1_launches=launches)
    return launches, dirs, counts, feat


# of the reference's 200 iterations. DPM's loss need not fall at every
# iteration (V restarts from the encoder's prediction each time): on the
# card the MLP run's rose at its second of three (234,291, 237,040,
# 235,182), so the runs are long enough for the last to be below the first
DPM_ITERS = {"mlp": 5, "sdae": 4}
FIT_BATCHES = (64, 1024)  # the reference MLP's batch, and DPM's fast mode


def dpm_train(dev, root):
    """Phase 10a: ``train --model dpm`` at k = 50, d = 20,000 through the CLI
    with the MLP encoder (``--log-dir``, ``--save-lag 1``) and the SDAE
    encoder, and the MLP's untrained tables. Returns {run: dir}."""
    content = ["--content", "meta.pkl", "--d", str(CONTENT_D)]
    runs = {  # run: (encoder, iterations, extra flags)
        "dpm": ("mlp", DPM_ITERS["mlp"],
                ["--save-lag", "1", "--log-dir", os.path.join(root, "dpm")]),
        "dpm_sdae": ("sdae", DPM_ITERS["sdae"], []),
        "dpm0": ("mlp", 0, []),
    }
    dirs = {}
    for name, (encoder, iters, extra) in runs.items():
        out = os.path.join(root, name)
        lines, wall = run_cli(
            ["train", "--model", "dpm", "-d", root, "-o", out, "--k",
             str(CONTENT_K), "--encoder", encoder, "--max-iter", str(iters),
             "--device", str(dev)] + content + extra)
        hits = [m for m in map(ITER_RE.search, lines) if m]
        losses = [float(m.group(1)) for m in hits]
        phase("dpm_train", run=name, encoder=encoder, k=CONTENT_K,
              d=CONTENT_D, hidden="2000x1000", wall_s=f"{wall:.3f}",
              losses="|".join(m.group(1) for m in hits),
              s_per_iter="|".join(m.group(2) for m in hits),
              cut=f"{iters}_of_200_iterations")
        if len(losses) != iters or not np.all(np.isfinite(losses)) or (
                iters and not losses[-1] < losses[0]):
            raise AssertionError(f"{name}: losses not finite, or the last "
                                 f"not below the first: {losses}")
        files = ["final-U.dat", "final-V.dat", "checkpoint.npz"]
        if extra:
            files += ["state.log", "settings.txt", "0000-U.dat"]
        for f in files:
            if not os.path.exists(os.path.join(out, f)):
                raise AssertionError(f"train --model dpm ({name}) wrote no "
                                     f"{f}")
        dirs[name] = out
    return dirs


def dpm_rates(dev, root, feat):
    """Phase 10c: the layers' times on the card. One DPM iteration after a
    warm-up one, split by CUDA events into the encoder's predict, the user
    and item half-sweeps and the encoder's fit sweep (batch 64); the fit
    sweep at batch 64 and 1,024 (CUDA events over two sweeps after a
    warm-up) with torch.profiler's launches per step and the busy share;
    and one SDAE pretraining epoch of each hidden layer."""
    from topk_rec_torch.cli import _load_fold
    from topk_rec_torch.models import DPM, MLPEncoder, SDAEEncoder
    from topk_rec_torch.models.encoders import _dae_pretrain_epoch
    from topk_rec_torch.ops.als import half_sweep

    inter, _, _ = _load_fold(root, 0)
    model = DPM(k=CONTENT_K, d=CONTENT_D, device=dev)
    model.set_interactions(inter)
    model.set_features(feat)
    enc = MLPEncoder(CONTENT_K, CONTENT_D, device=dev)
    t = model._device_tables()

    def iteration():
        Fe, predict = timed_ms(lambda: enc._predict_dev(feat))
        (t.U, _), users = timed_ms(lambda: half_sweep(
            model._user_plan, t.U, Fe, model._rated_items, model.a, model.b,
            model.lu, as_numpy=False))
        (t.V, fit), items = timed_ms(lambda: half_sweep(
            model._item_plan, Fe, t.U, model._rated_users, model.a, model.b,
            model.lv, prior=Fe, as_numpy=False))
        loss, sweep = timed_ms(lambda: enc._fit_sweep(feat, t.V))
        return float(fit + loss), (predict, users, items, sweep)

    iteration()  # warm-up
    loss, split = iteration()
    phase("dpm_iteration", batch=64, loss=f"{loss:.6f}",
          predict_ms=f"{split[0]:.4f}", user_sweep_ms=f"{split[1]:.4f}",
          item_sweep_ms=f"{split[2]:.4f}", fit_sweep_ms=f"{split[3]:.4f}",
          total_ms=f"{sum(split):.4f}")
    for batch in FIT_BATCHES:
        enc.batch_size = batch
        enc._fit_sweep(feat, t.V)  # warm-up
        sweep_ms = cuda_median_ms(lambda: enc._fit_sweep(feat, t.V), reps=2,
                                  warmup=0)
        kernels = profiled_kernels(lambda: enc._fit_sweep(feat, t.V))
        busy_us = sum(e.time_range.elapsed_us() for e in kernels)
        steps = -(-N_ITEMS // batch)
        phase("dpm_fit_sweep", batch=batch, steps=steps,
              sweep_ms=f"{sweep_ms:.4f}",
              ms_per_step=f"{sweep_ms / steps:.4f}",
              kernels_per_step=f"{len(kernels) / steps:.1f}",
              busy_share=(f"{busy_us / (sweep_ms * 1e3):.4f}" if kernels
                          else "not measured"))
    del model, enc, t

    sdae = SDAEEncoder(CONTENT_K, CONTENT_D, device=dev)
    H = sdae._feat_dev(feat)
    epoch_ms = []
    for li in range(sdae.n_layers - 1):
        W, b = sdae.params[li]
        p = [W, b, W.detach().T.contiguous().requires_grad_(),
             torch.zeros(W.shape[0], device=dev, requires_grad=True)]
        acc = [torch.zeros_like(x) for x in p]

        def epoch():
            idx, ok = sdae._batches(H.shape[0])
            masks = sdae._draw_masks(idx.shape[0] // sdae.batch_size,
                                     W.shape[0])
            return float(_dae_pretrain_epoch(
                p, acc, H, idx, ok, masks, sdae.pretrain_lr, sdae.batch_size,
                li == 0))

        loss, ms = timed_ms(epoch)
        if not np.isfinite(loss):
            raise AssertionError(f"SDAE layer {li}: loss {loss}")
        epoch_ms.append(ms)
        with torch.no_grad():
            H = torch.sigmoid(torch.addmm(b, H, W))
    phase("dpm_sdae_pretrain", batch=sdae.batch_size,
          **{f"layer{i}_epoch_ms": f"{ms:.4f}" for i, ms in
             enumerate(epoch_ms)},
          layer_widths=f"{CONTENT_D}x2000|2000x1000")


def dpm_path(dev, root, feat, counts):
    """Phase 10: DPM with each encoder on phase 9's fold and features, its
    tables through K1, and the layers' times. Returns K1's launches and the
    trained MLP-DPM's dir."""
    t0 = time.perf_counter()
    dirs = dpm_train(dev, root)
    launches = content_evaluate(
        dev, root, {"dpm": (dirs["dpm"], dirs["dpm0"]),
                    "dpm_sdae": (dirs["dpm_sdae"], None)}, counts, tag="dpm")
    dpm_rates(dev, root, feat)
    phase("dpm", seconds=f"{time.perf_counter() - t0:.2f}",
          k1_launches=launches)
    return launches, dirs["dpm"]


def check_fuse_lines(lines, names):
    """Each line ``name,acc@5,...,acc@30``: the names in order, six
    accuracies, finite and in [0, 1]."""
    if [ln.split(",")[0] for ln in lines] != names:
        raise AssertionError(f"fuse printed {lines}, expected {names}")
    for ln in lines:
        acc = np.array(ln.split(",")[1:], float)
        if acc.shape != (6,) or not np.all(np.isfinite(acc)) or \
                not np.all((acc >= 0) & (acc <= 1)):
            raise AssertionError(f"fuse: implausible accuracies: {ln}")


def fuse_path(dev, root, models):
    """Phase 11: ``fuse`` of the four trained modalities through the CLI
    with every strategy and the p-sweep; the weight fits timed alone (the
    CLI's sample counts); then ``evaluate_fused`` with average weights held
    to K1 on the concatenated tables. Returns K1's launches."""
    from topk_rec_torch.cli import FUSE_STRATEGIES, _load_fold, \
        _read_model_mat, _scenario_inputs
    from topk_rec_torch.eval.device import DeviceEvaluator
    from topk_rec_torch.fusion import (
        ModalityScores,
        average_weights,
        bpr_fusion_weights,
        error_weights,
        evaluate_fused,
        svm_fusion_weights,
    )
    from topk_rec_torch.ops.topk_fused import fused_score_topk

    t0 = time.perf_counter()
    fused_score_topk.launches = 0
    scen = ["zp", COLD]
    common = ["-d", root, "-m", *models, "-sl", *scen, "--device", str(dev)]
    for strategy in FUSE_STRATEGIES:
        lines, wall = run_cli(["fuse", "--strategy", strategy] + common)
        check_fuse_lines(lines, [f"{strategy}-{sc}" for sc in scen])
        phase("fuse", strategy=strategy, modalities=len(models),
              wall_s=f"{wall:.3f}", csv="|".join(lines))
    lines, wall = run_cli(["fuse", "--strategy", "rank", "--p-sweep"]
                          + common)
    check_fuse_lines(lines, [f"rank-p{p / 10}-{sc}" for p in range(1, 10)
                             for sc in scen])
    phase("fuse", strategy="rank_p_sweep", lines=len(lines),
          wall_s=f"{wall:.3f}", csv="|".join(lines))

    inter, uids, iids = _load_fold(root, 0)
    emb = [(_read_model_mat(m, "final-U.dat", uids),
            _read_model_mat(m, "final-V.dat", iids)) for m in models]
    mods = ModalityScores(emb, device=dev)
    fits = (("error", lambda: error_weights(mods, inter,
                                            np.arange(inter.n_items))),
            ("svm", lambda: svm_fusion_weights(mods, inter)),
            ("bpr", lambda: bpr_fusion_weights(mods, inter)))
    for name, fit in fits:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        w = fit()  # host arrays: the card is done
        fit_ms = (time.perf_counter() - t1) * 1e3
        shown = (f"mean_{'|'.join(f'{x:.4f}' for x in w.mean(0))}"
                 if w.ndim == 2 else "|".join(f"{x:.6f}" for x in w))
        if not np.all(np.isfinite(w)):
            raise AssertionError(f"{name} weights not finite: {w}")
        phase("fuse_fit", strategy=name, fit_ms=f"{fit_ms:.1f}",
              samples={"error": 0, "svm": 100_000, "bpr": 10_000_000}[name],
              weights=shown)

    w = average_weights(len(models))
    U_cat = np.concatenate([w[f] * U for f, (U, _) in enumerate(emb)], 1)
    V_cat = np.concatenate([V for _, V in emb], 1)
    ev = DeviceEvaluator(inter.seen_bitmap, use_kernel=True, want_rr=False,
                         device=dev)
    for sc in scen:
        cand_ids, likes = _scenario_inputs(root, 0, sc, uids, iids)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fused = evaluate_fused(mods, w, inter.seen_bitmap, cand_ids, likes)
        fused_ms = (time.perf_counter() - t1) * 1e3
        before = fused_score_topk.launches
        t1 = time.perf_counter()
        k1 = ev.evaluate(U_cat, V_cat, None, cand_ids, likes)
        k1_ms = (time.perf_counter() - t1) * 1e3
        n = fused_score_topk.launches - before
        a_f, a_k = fused.accuracy, k1.accuracy
        phase("fuse_k1", scenario=sc, d=V_cat.shape[1], likes=fused.count,
              launches=n, evaluate_fused_ms=f"{fused_ms:.1f}",
              k1_evaluate_ms=f"{k1_ms:.1f}",
              fused="|".join(f"{x:.6f}" for x in a_f),
              k1="|".join(f"{x:.6f}" for x in a_k))
        if n <= 0 or fused.count != k1.count or \
                not np.all(np.abs(a_f - a_k) <= 2 / fused.count):
            raise AssertionError(f"evaluate_fused {a_f} vs K1 {a_k} on {sc} "
                                 f"({n} launches)")
    phase("fuse_done", seconds=f"{time.perf_counter() - t0:.2f}",
          k1_launches=fused_score_topk.launches)
    return fused_score_topk.launches


MESH_STEPS = 16  # steps of the one distributed chunk per trainer case


def close_max(got, want, rtol):
    """|got - want| within rtol of want's largest entry."""
    got, want = (np.asarray(torch.as_tensor(x).detach().cpu())
                 for x in (got, want))
    return bool(np.all(np.abs(got - want)
                       <= rtol * max(1e-30, float(np.abs(want).max()))))


def chunk_close(got, want):
    """The tolerance of tests/test_parallel.py for a training chunk:
    rtol 2e-4 / atol 1e-5."""
    return all(torch.allclose(got[n].float(), want[n].float(), rtol=2e-4,
                              atol=1e-5) for n in want)


def collective_share(fn):
    """(kernels, their device µs, the NCCL kernels' µs) of fn() under
    torch.profiler: how much of the meshed work is the collectives' own
    device time."""
    kernels = profiled_kernels(fn)
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    return (len(kernels),
            f"{sum(e.time_range.elapsed_us() for e in kernels):.1f}",
            f"{sum(e.time_range.elapsed_us() for e in nccl):.1f}")


def mesh_serving(dev, mesh, fold):
    """Phase 12a: ``TopKServer(mesh=)`` against the un-meshed server on four
    256-user batches with ``kernel``, ``hybrid`` and ``exact``, and one
    batch served from a sticky lookup capacity of 1. The launch counts are
    set to 0 after the un-meshed server's lists are made, so they count the
    meshed server's. Returns the meshed server, the un-meshed one and a
    batch of user ids."""
    from topk_rec_torch.ops.topk_fused import fused_score_topk
    from topk_rec_torch.ops.topk_hybrid import count_vs_threshold
    from topk_rec_torch.serving import TopKServer

    inter, U, V, B = fold
    local = TopKServer(U, V, B, inter, device=dev)
    meshed = TopKServer(U, V, B, inter, mesh=mesh)
    rng = np.random.default_rng(12)
    batches = [rng.choice(N_USERS, 256, replace=False) for _ in range(4)]
    methods = ("kernel", "hybrid", "exact")
    want = {(m, b): local.recommend(users, TOP_K, m)
            for m in methods for b, users in enumerate(batches)}
    fused_score_topk.launches = 0
    count_vs_threshold.launches = 0
    for (method, b), (wv, wi) in want.items():
        got = meshed.recommend(batches[b], TOP_K, method)
        if not (np.array_equal(got[1], wi) and np.array_equal(got[0], wv)):
            raise AssertionError(f"meshed {method} lists differ from the "
                                 "un-meshed server's")
    tried = []
    ask = meshed.recommend_async

    def logged(*a, **kw):
        tried.append(meshed._lookup_capacity)
        return ask(*a, **kw)

    meshed.recommend_async = logged
    meshed._lookup_capacity = 1
    got = meshed.recommend(batches[0], TOP_K, "kernel")
    del meshed.recommend_async
    if not np.array_equal(got[1], want[("kernel", 0)][1]) or \
            tried[0] != 1 or meshed._lookup_capacity != 256:
        raise AssertionError(f"forced overflow: capacities {tried}")
    # the kernel copies follow their tables (serving.py), the sharded U and
    # the replicated V alike
    for srv in (meshed, local):
        srv.U.mul_(-1.0)
        srv.V.mul_(0.5)
    got = meshed.recommend(batches[1], TOP_K, "kernel")
    flipped = local.recommend(batches[1], TOP_K, "kernel")
    if not np.array_equal(got[1], flipped[1]) or \
            np.array_equal(got[1], want[("kernel", 1)][1]):
        raise AssertionError("the meshed server's kernel tables did not "
                             "follow U and V")
    for srv in (meshed, local):
        srv.U.mul_(-1.0)
        srv.V.mul_(2.0)
    phase("mesh_serve", batches=len(batches), users=256,
          methods="kernel|hybrid|exact", equal_to_unmeshed=True,
          kernel_tables_follow=True,
          forced_capacities="|".join(map(str, tried)))
    return meshed, local, batches[0]


def mesh_train_cli(dev, root):
    """Phase 12b: ``train --model bpr --mesh 1x1`` through the CLI (one
    epoch of 131,072 samples), then ``evaluate -sl zp`` of its tables and
    of phase 8's untrained ones through K1: the trained tables must score
    higher at accuracy@30."""
    out = os.path.join(root, "bpr_mesh")
    lines, wall = run_cli(["train", "--model", "bpr", "-d", root, "-o", out,
                           "--k", str(DIM), "--batch-size", "256", "--lr",
                           str(TRAIN_LR), "--epochs", "1",
                           "--epoch-sample-limit", "131072", "--mesh", "1x1",
                           "--device", str(dev)])
    epochs = [ln for ln in lines if "(mesh {'dp': 1, 'mp': 1})" in ln]
    if len(epochs) != 1 or not os.path.exists(os.path.join(out,
                                                           "final-U.dat")):
        raise AssertionError(f"train --mesh 1x1 printed {lines}")
    acc = {}
    for name in ("bpr_mesh", "bpr0"):
        ev, _ = run_cli(["evaluate", "-d", root, "-m",
                         os.path.join(root, name), "-sl", "zp", "--device",
                         str(dev)])
        acc[name] = float(ev[0].split(",")[-1])
    phase("mesh_train_cli", mesh="1x1", samples=131072,
          loss=EPOCH_RE.search(epochs[0]).group(1), wall_s=f"{wall:.3f}",
          trained_at_30=acc["bpr_mesh"], untrained_at_30=acc["bpr0"])
    if not acc["bpr_mesh"] > acc["bpr0"]:
        raise AssertionError(f"train --mesh 1x1: accuracy@30 {acc}")


def mesh_trainers(dev, mesh, inter, feat):
    """Phase 12c: one chunk of each distributed trainer against the local
    chunk on the same triplets and state: BPR at k = 50 with ``gspmd`` and
    ``explicit`` at batch 256 and 8,192, VBPR at d = 20,000; ms per step
    (CUDA events over a chunk after a warm-up one) and launches per step
    (torch.profiler), beside the local chunk's."""
    from topk_rec_torch.models import BPR, VBPR
    from topk_rec_torch.models import bpr as tbpr
    from topk_rec_torch.models import vbpr as tvbpr
    from topk_rec_torch.models.bpr import INIT_STREAM, stream_generator
    from topk_rec_torch.parallel import (
        DistributedBPRTrainer,
        DistributedVBPRTrainer,
    )

    def rate(run, u, i, j):
        """(ms per step, launches per step, device µs per step, NCCL µs per
        step)."""
        run(u, i, j)  # warm-up
        torch.cuda.synchronize()
        _, ms = timed_ms(lambda: run(u, i, j))
        n, busy, nccl = collective_share(lambda: run(u, i, j))
        return (f"{ms / MESH_STEPS:.4f}", f"{n / MESH_STEPS:.1f}",
                f"{float(busy) / MESH_STEPS:.1f}",
                f"{float(nccl) / MESH_STEPS:.1f}")

    cases = [("bpr", ex, b) for ex in ("gspmd", "explicit")
             for b in (256, 8192)] + [("vbpr", "gspmd", 256)]
    for model_name, ex, batch in cases:
        if model_name == "bpr":
            model = BPR(k=DIM, lr=TRAIN_LR, device=dev)
            make = lambda m: DistributedBPRTrainer(  # noqa: E731
                m, mesh, batch_size=batch, scan_steps=MESH_STEPS, exchange=ex)
        else:
            model = VBPR(k=CONTENT_K, d=CONTENT_D, lr=TRAIN_LR,
                         lambda_b=VBPR_LB, device=dev)
            make = lambda m: DistributedVBPRTrainer(  # noqa: E731
                m, mesh, batch_size=batch, scan_steps=MESH_STEPS)
        model.set_interactions(inter)
        if model_name == "vbpr":
            model.set_features(feat)
        model._init_params(stream_generator(0, INIT_STREAM, dev))
        # accumulators of 0.01: from zero, RMSProp's first step is
        # ±3.16·lr whatever the gradient's size, so a gradient near zero
        # would turn on the order of its sums
        model.tables.load(ms={n: torch.full_like(t, 0.01) for n, t in
                              model.tables.ms().items()})
        params = {n: t.clone() for n, t in model.tables.params().items()}
        ms0 = {n: t.clone() for n, t in model.tables.ms().items()}
        trainer = make(model)
        u, i, j = trainer.sample_chunk(stream_generator(0, 0, dev))
        loss = trainer.run_chunk(u, i, j)
        got = trainer.state()
        local = model.tables
        local.load(params, ms0)
        hyper = model.hyper()
        if model_name == "bpr":
            def local_run(u, i, j):
                return tbpr.run_chunk(local, u, i, j, hyper, model.mode)
        else:
            fdev = model._feat_device()

            def local_run(u, i, j):
                return tvbpr.run_chunk(local, fdev, u, i, j, hyper,
                                       model.mode)
        want_loss = float(local_run(u, i, j))
        if not (chunk_close(got[0], local.params())
                and chunk_close(got[1], local.ms())
                and abs(loss - want_loss) <= 1e-4 * abs(want_loss)):
            raise AssertionError(f"{model_name} {ex} batch {batch}: the "
                                 "distributed chunk differs from the local")
        mesh_ms, mesh_launch, mesh_us, nccl_us = rate(trainer.run_chunk,
                                                      u, i, j)
        local_ms, local_launch, local_us, _ = rate(local_run, u, i, j)
        phase("mesh_train", model=model_name, exchange=ex, batch=batch,
              steps=MESH_STEPS, loss=f"{loss:.4f}", equal_to_local=True,
              ms_per_step=mesh_ms, local_ms_per_step=local_ms,
              launches_per_step=mesh_launch,
              local_launches_per_step=local_launch,
              device_us_per_step=mesh_us, nccl_us_per_step=nccl_us,
              local_device_us_per_step=local_us)
        del model, trainer, local


def mesh_als_and_encoder(dev, mesh, inter, feat):
    """Phase 12d: ``DistributedALS.half_sweep`` of each side against the
    local ``half_sweep`` (rtol 1e-4), and one data-parallel fit sweep of
    the MLP encoder (d = 20,000 -> 2,000 -> 1,000 -> 50, batch 64) against
    the local sweep from the same weights and shuffle; times of each."""
    from topk_rec_torch.models import WMF, MLPEncoder
    from topk_rec_torch.ops.als import half_sweep
    from topk_rec_torch.parallel import DistributedALS

    wmf = WMF(k=CONTENT_K, device=dev)
    wmf.set_interactions(inter)
    t = wmf._device_tables()
    dals = DistributedALS(mesh)
    sides = {"user": (wmf._user_plan, t.U, t.V, wmf._rated_items, wmf.lu),
             "item": (wmf._item_plan, t.V, t.U, wmf._rated_users, wmf.lv)}
    for side, (plan, this, other, rated, lam) in sides.items():
        calls = {}
        for name, fn in (("mesh", dals.half_sweep), ("local", half_sweep)):
            calls[name] = lambda fn=fn: fn(plan, this, other, rated, wmf.a,
                                           wmf.b, lam, as_numpy=False)
        (got, gfit), (want, wfit) = calls["mesh"](), calls["local"]()
        if not (close_max(got, want, 1e-4)
                and abs(float(gfit) - float(wfit)) <= 1e-4 * abs(float(wfit))):
            raise AssertionError(f"DistributedALS {side} sweep differs")
        phase("mesh_als", side=side, k=CONTENT_K, equal_to_local=True,
              ms=f"{cuda_median_ms(calls['mesh'], reps=3, warmup=1):.4f}",
              local_ms=f"{cuda_median_ms(calls['local'], reps=3, warmup=1):.4f}")
    Y = t.V.clone()
    del wmf, t, dals

    local = MLPEncoder(CONTENT_K, CONTENT_D, device=dev)
    meshed = MLPEncoder(CONTENT_K, CONTENT_D, mesh=mesh)
    meshed.load_state_dict(local.state_dict())
    (want, want_ms), (got, got_ms) = (timed_ms(lambda e=e: e.fit(feat, Y))
                                      for e in (local, meshed))
    ws, gs = local.state_dict(), meshed.state_dict()
    if abs(got - want) > 1e-4 * abs(want) or not all(
            close_max(gs[n], ws[n], 1e-4) for n in ws):
        raise AssertionError("the data-parallel encoder sweep differs")
    n, busy, nccl = collective_share(lambda: meshed.fit(feat, Y))
    phase("mesh_encoder_fit", batch=local.batch_size,
          widths=f"{CONTENT_D}x2000x1000x{CONTENT_K}", loss=f"{got:.4f}",
          equal_to_local=True,
          sweep_ms=f"{got_ms:.4f}", local_sweep_ms=f"{want_ms:.4f}",
          launches=n, device_us=busy, nccl_us=nccl)


def mesh_scores(dev, mesh, fold):
    """Phase 12e: ``distributed_scores_topk`` on 8,192 users of phase 6's
    tables against the product and the stable top-k on the card."""
    from topk_rec_torch.ops.topk_fused import topk_stable
    from topk_rec_torch.parallel.train_step import distributed_scores_topk

    _, U, V, B = fold
    U = U[:8192]
    (vals, idx), ms = timed_ms(
        lambda: distributed_scores_topk(mesh, U, V, B, TOP_K))
    Ud, Vd, Bd = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in (U, V, B.reshape(-1)))
    wv, wi = topk_stable(Ud @ Vd.T + Bd[None, :], TOP_K)
    if not (np.array_equal(idx, wi.cpu().numpy())
            and np.allclose(vals, wv.cpu().numpy(), rtol=TOL, atol=TOL)):
        raise AssertionError("distributed_scores_topk differs")
    phase("mesh_scores", users=8192, items=N_ITEMS, k=TOP_K,
          equal_to_plain=True, call_ms=f"{ms:.4f}")


def mesh_collectives(mesh):
    """Phase 12f: host µs per call of each collective the mesh uses, on
    this 1 x 1 mesh (200 calls after 10, then one synchronize), beside one
    small elementwise op: what a collective costs the host that dispatches
    it, apart from its bytes."""
    import torch.distributed as dist

    from topk_rec_torch.parallel.distributed import all_gather_rows, \
        all_to_all

    idx = torch.arange(512, device=mesh.device)
    one = torch.zeros(1, dtype=torch.int32, device=mesh.device)
    calls = {
        "all_to_all_512": lambda: all_to_all(idx, mesh.groups["mp"]),
        "all_gather_1": lambda: all_gather_rows(one, mesh.groups["mp"]),
        "all_reduce_4b": lambda: dist.all_reduce(one, group=mesh.groups["dp"]),
        "add_512": lambda: idx + 1,
    }
    us = {}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        us[f"{name}_host_us"] = f"{(time.perf_counter() - t0) / 200 * 1e6:.1f}"
        torch.cuda.synchronize()
    phase("mesh_collectives", **us)


def mesh_path(dev, root, feat):
    """Phase 12: the mesh on a 1 x 1 NCCL mesh at full width. Returns the K1
    and K2 launches of its main path (the meshed serving and the evaluate
    of the mesh-trained tables)."""
    import torch.distributed as dist

    from topk_rec_torch.cli import _load_fold, _read_model
    from topk_rec_torch.ops.topk_fused import fused_score_topk
    from topk_rec_torch.ops.topk_hybrid import count_vs_threshold
    from topk_rec_torch.parallel import make_mesh

    t0 = time.perf_counter()
    inter, uids, iids = _load_fold(root, 0)
    fold = (inter, *_read_model(os.path.join(root, "model"), uids, iids))
    mesh = make_mesh(dp=1, mp=1, device=dev)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"the mesh runs on {dist.get_backend()}")
    phase("mesh", shape="1x1", backend="nccl", device=str(mesh.device),
          load_and_init_s=f"{time.perf_counter() - t0:.2f}")
    try:
        meshed, local, users = mesh_serving(dev, mesh, fold)
        mesh_train_cli(dev, root)
        k1, k2 = fused_score_topk.launches, count_vs_threshold.launches
        if k1 <= 0 or k2 <= 0:
            raise AssertionError(f"the mesh path launched K1 {k1}, K2 {k2} "
                                 "times")
        ms = {}
        for method in ("kernel", "hybrid", "exact"):
            for name, srv in (("mesh", meshed), ("local", local)):
                t = cuda_median_ms(
                    lambda: srv.recommend_async(users, TOP_K, method))
                ms[f"{method}_{name}_ms"] = f"{t:.4f}"
        n, busy, nccl = collective_share(
            lambda: meshed.recommend_async(users, TOP_K, "kernel"))
        phase("mesh_serve_latency", users=256, **ms, kernel_mesh_launches=n,
              kernel_mesh_device_us=busy, kernel_mesh_nccl_us=nccl)
        del meshed, local
        mesh_trainers(dev, mesh, inter, feat)
        mesh_als_and_encoder(dev, mesh, inter, feat)
        mesh_scores(dev, mesh, fold)
        mesh_collectives(mesh)
    finally:
        dist.destroy_process_group()
    phase("mesh_done", seconds=f"{time.perf_counter() - t0:.2f}",
          k1_launches=k1, k2_launches=k2)
    return k1, k2


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke needs one card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from topk_rec_torch.device import resolve_device
    from topk_rec_torch.ops import _build

    gpu = gpu_line()
    print(gpu, flush=True)
    phase("device", torch=torch.__version__, cuda=torch.version.cuda,
          name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    dev = resolve_device("cuda")

    t0 = time.perf_counter()
    _build.load_library()
    phase("build", seconds=f"{time.perf_counter() - t0:.2f}",
          nvcc_seconds=_build.build_seconds, hash=_build.source_hash())
    from topk_rec_torch.native import io_native

    t0 = time.perf_counter()
    if not io_native.available():
        raise AssertionError("the port's C++ parser did not build")
    phase("build_parser", seconds=f"{time.perf_counter() - t0:.2f}")

    max_err, times = kernel_cases(dev)
    k1 = times[(8192, "fp32")]     # one evaluate chunk
    k2_err, k2_times = k2_cases(dev)
    k2 = k2_times[(256, "bf16")]   # recommend's shape
    hybrid_cases(dev)

    root = tempfile.mkdtemp(prefix=".smoke_", dir=ROOT)
    try:
        launches, count_launches, (pu, pi) = main_path(dev, root)
        if launches <= 0 or count_launches <= 0:
            raise AssertionError("the main path never launched K1 or K2")
        floor_err, floor_yards = floor_cases(dev)
        floor_launches, floor_ms = floor_path(dev)
        if floor_launches <= 0:
            raise AssertionError("the floor probe never launched P1")
        t_launches, t_count_launches = train_path(dev, root, pu, pi)
        if t_launches <= 0 or t_count_launches <= 0:
            raise AssertionError("the trained tables never went through K1 "
                                 "or K2")
        train_rate(dev, root)
        t_launches += train_layout(dev, root)
        c_launches, dirs, counts, feat = content_path(dev, root)
        if c_launches <= 0:
            raise AssertionError("the content models' tables never went "
                                 "through K1")
        d_launches, dpm_dir = dpm_path(dev, root, feat, counts)
        if d_launches <= 0:
            raise AssertionError("the DPM tables never went through K1")
        f_launches = fuse_path(dev, root, [dirs["vbpr"][0], dirs["wmf"][0],
                                           dirs["cer"][0], dpm_dir])
        if f_launches <= 0:
            raise AssertionError("the fusion check never launched K1")
        m_launches, m_count_launches = mesh_path(dev, root, feat)
        del feat
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches += t_launches + c_launches + d_launches + f_launches + m_launches
    count_launches += t_count_launches + m_count_launches

    print(json.dumps({"kernels": [{
        "name": "topk_fused",
        "route": "cuda",
        "source": "topk_rec_torch/csrc/topk_fused.cu",
        "replaces": "topk_rec_tpu/ops/topk_pallas.py:119",
        "launches": launches,
        "max_abs_err": max_err,
        **k1,
    }, {
        "name": "topk_count",
        "route": "cuda",
        "source": "topk_rec_torch/csrc/topk_count.cu",
        "replaces": "topk_rec_tpu/ops/topk_hybrid.py:55",
        "launches": count_launches,
        "max_abs_err": k2_err,
        **k2,
    }, {
        "name": "topk_floor",
        "route": "cuda",
        "source": "topk_rec_torch/csrc/topk_floor.cu",
        "replaces": "benchmarks/probe_topk_floor.py:44",
        "launches": floor_launches,
        "max_abs_err": floor_err,
        "ms": floor_ms["fp32"]["p1_a"],
        **floor_yards[("fp32", "A")],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
