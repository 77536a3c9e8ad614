"""Smoke run of the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one result line; any failure raises and exits non-zero
without the final ``ok`` line):

1. identify the card (``nvidia-smi`` name and power limit, torch and CUDA);
2. build the kernels K1 (fused top-k) and K2 (threshold count) from
   ``topk_rec_torch/csrc`` with nvcc, one process per source;
3. compare K1 with its plain PyTorch twin on the card, exact (fp32) and
   serving (bf16) mode, on ragged shapes, no bias, rows with fewer than k
   unseen items, an all-ties row, k = 1 and k = 128, and the full-width
   eval chunk (8,192 users x 10,380 items, d = 50, k = 30), with CUDA-event
   medians of both;
4. compare K2 with its twin in both modes (ragged, no bias, all ties, rows
   with fewer than k unseen, t from the exact top-k so that ties sit at the
   threshold), and time both at 256 and 8,192 users at full width;
5. compare ``exact_topk_hybrid`` with K1 and K1's twin at 256 and 8,192
   users, at the defaults and at settings that force repairs (k_extra = 0,
   recall = 0.8, cap = 32), printing the repaired rows and its time;
6. drive the main path at the full MovieLens width through
   ``topk_rec_torch.cli.main``: a generated fold of 69,878 users x 10,380
   items in the reference file formats with seeded ``final-U/V/B.dat``
   (d = 50); ``evaluate -sl im om`` with ``--engine kernel`` and ``torch``,
   ``recommend -k 30`` with ``--method kernel``, ``exact``, ``hybrid`` and
   ``approx`` for 256 users. K1's launch counter must rise in each kernel
   run and K2's in the hybrid run; the engines must agree, the exact
   methods' recommendations must match a float64 NumPy reference, and the
   approx lists must be valid with a mean recall@30 of at least 0.9. Then
   each method's served-batch time at 256 and 8,192 users;
7. "floor": compare P1 (the per-residue running max, the floor of K1)
   with its plain version in both modes and both variants (value only,
   value + index) on a ragged shape, no bias, a fully masked row, all ties,
   fewer items than residues and the probe's full shape (69,878 x 10,380,
   d = 50, 2 % masked); then, with the counts at 0, the probe itself:
   CUDA-event medians of P1-A, P1-B, K1 at k = 1 and K1 at k = 30 on all
   69,878 users in both modes;
8. "train": ``train --model bpr --k 50 --batch-size 256`` for two epochs
   through ``topk_rec_torch.cli.main`` on phase 6's fold (losses finite and
   falling, ``final-U/V/B.dat`` and ``checkpoint.npz`` written), then
   ``evaluate`` of the trained tables with both engines on held-out likes
   drawn from the fold's own zipf law (K1's count must rise; the engines
   must agree; accuracy@30 must beat the untrained tables', ``--epochs
   0``), ``recommend --method kernel`` and ``hybrid`` on the trained tables,
   and training samples/s at batch 256 and 8,192 (CUDA events over whole
   chunks after a warm-up chunk) with the kernel launches per step.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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


def kernel_cases(dev):
    """Phase 3: K1 against its twin; returns (max_abs_err, ms, plain_ms)."""
    from topk_rec_torch.ops.topk_fused import (
        fused_score_topk,
        fused_score_topk_plain,
    )

    def make(n_u, n_i, d, seed, bias=True, ties=False):
        return make_case(dev, n_u, n_i, d, seed, bias, ties)

    cases = [  # (n_u, n_i, d, k, bias, ties)
        (37, 301, 13, 8, True, False),      # ragged, n_i % 32 != 0
        (130, 1000, 50, 30, False, False),  # no bias
        (5, 4173, 50, 128, True, False),    # k = 128, split merge
        (3, 100, 2, 1, True, False),        # k = 1
        (16, 700, 2, 6, False, True),       # all-ties rows
        (256, N_ITEMS, DIM, TOP_K, True, False),   # serving batch
        (8192, N_ITEMS, DIM, TOP_K, True, False),  # full-width chunk
    ]
    worst = 0.0
    times = {}
    for n_u, n_i, d, k, bias, ties in cases:
        U, V, b, words = make(n_u, n_i, d, seed=n_u * 7 + n_i, bias=bias,
                              ties=ties)
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
                tk = cuda_median_ms(
                    lambda: fused_score_topk(U, V, b, words, k,
                                             exact_matmul=exact))
                tp = cuda_median_ms(
                    lambda: fused_score_topk_plain(U, V, b, words, k,
                                                   exact_matmul=exact))
                times[(n_u, mode)] = (tk, tp)
                fields.update(kernel_ms=f"{tk:.4f}", plain_ms=f"{tp:.4f}")
            phase("k1_vs_plain", **fields)
    return worst, times


K2_CASES = [  # (n_u, n_i, d, k, bias, ties)
    (37, 301, 13, 8, True, False),      # ragged, n_i % 32 != 0
    (130, 1000, 50, 30, False, False),  # no bias
    (16, 700, 2, 6, False, True),       # all-ties rows
    (256, N_ITEMS, DIM, TOP_K, True, False),   # serving batch
    (8192, N_ITEMS, DIM, TOP_K, True, False),  # full-width chunk
]


def k2_cases(dev):
    """Phase 4: K2 against its twin in both modes, with t from the exact
    top-k (ties at the threshold; t = NEG_INF on row 0, which has fewer
    than k unseen items). A count may differ only by the number of
    elements whose twin score lies within 1e-5·max(1, |s|) of t ± eps,
    where the two summation orders can fall on either side.

    Returns (largest count difference, {(n_u, mode): (ms, plain_ms)})."""
    from topk_rec_torch.ops.topk_fused import (
        fused_score_topk_plain,
        masked_scores,
    )
    from topk_rec_torch.ops.topk_hybrid import (
        count_vs_threshold,
        count_vs_threshold_plain,
    )

    worst = 0
    times = {}
    for n_u, n_i, d, k, bias, ties in K2_CASES:
        U, V, b, words = make_case(dev, n_u, n_i, d, seed=n_u * 11 + n_i,
                                   bias=bias, ties=ties)
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
                tk = cuda_median_ms(
                    lambda: count_vs_threshold(U, V, b, words, t, exact))
                tp = cuda_median_ms(
                    lambda: count_vs_threshold_plain(U, V, b, words, t,
                                                     exact))
                times[(n_u, mode)] = (tk, tp)
                fields.update(kernel_ms=f"{tk:.4f}", plain_ms=f"{tp:.4f}")
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


def floor_cases(dev):
    """Phase 7a: P1 against its plain version, both modes, both variants.
    Returns (max_abs_err, plain_ms of P1-A fp32 at the probe's shape)."""
    from topk_rec_torch.ops.topk_floor import topk_floor, topk_floor_plain

    cases = [  # (n_u, n_i, d, bias, ties)
        (37, 301, 13, True, False),      # ragged: n_i % 32, n_i % 128 != 0
        (130, 1000, 50, False, False),   # no bias
        (16, 700, 2, False, True),       # all ties
        (5, 90, 8, True, False),         # fewer items than residues
        (N_USERS, N_ITEMS, DIM, True, False),  # the probe's full shape
    ]
    worst = 0.0
    plain_ms = None
    for n_u, n_i, d, bias, ties in cases:
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
                fields = dict(n_u=n_u, n_i=n_i, d=d, mode="fp32" if exact
                              else "bf16", variant="B" if with_index else "A",
                              max_abs_err=err, mismatches=mism)
                if n_u == N_USERS and exact and not with_index:
                    plain_ms = cuda_median_ms(lambda: topk_floor_plain(
                        U, V, b, words, exact), reps=7, warmup=2)
                    fields.update(plain_ms=f"{plain_ms:.4f}")
                phase("floor_vs_plain", **fields)
    return worst, plain_ms


def floor_path(dev):
    """Phase 7b, the probe (probe_topk_floor.py:131-151) with the counts at
    0: medians of P1-A, P1-B, K1 at k = 1 (its variant C) and K1 at k = 30
    on the same 69,878 users, both modes. Returns (P1 launches, P1-A fp32
    ms)."""
    from topk_rec_torch.ops.topk_floor import topk_floor
    from topk_rec_torch.ops.topk_fused import fused_score_topk

    U, V, b, words = probe_case(dev)
    topk_floor.launches = 0
    ms_a = None
    for exact in (True, False):
        ms = {
            "p1_a": cuda_median_ms(lambda: topk_floor(U, V, b, words, exact)),
            "p1_b": cuda_median_ms(lambda: topk_floor(U, V, b, words, exact,
                                                      with_index=True)),
            "k1_k1": cuda_median_ms(
                lambda: fused_score_topk(U, V, b, words, 1, exact)),
            "k1_k30": cuda_median_ms(
                lambda: fused_score_topk(U, V, b, words, TOP_K, exact)),
        }
        if exact:
            ms_a = ms["p1_a"]
        phase("floor", users=N_USERS, items=N_ITEMS, d=DIM,
              mode="fp32" if exact else "bf16",
              **{f"{n}_ms": f"{t:.4f}" for n, t in ms.items()})
    return topk_floor.launches, ms_a


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
              csv="|".join(lines))
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


def serve_latency(root, dev):
    """CUDA-event medians of one served batch per method (the device time
    of ``recommend_async``; ``hybrid`` includes its host sync) at 256 and
    8,192 users, on the fold and tables as ``recommend`` loads them."""
    from topk_rec_torch.cli import _load_fold, _read_model
    from topk_rec_torch.serving import METHODS, TopKServer

    inter, uids, iids = _load_fold(root, 0)
    U, V, B = _read_model(os.path.join(root, "model"), uids, iids)
    srv = TopKServer(U, V, B, inter, device=dev)
    rng = np.random.default_rng(4)
    for n in (256, 8192):
        uids = rng.choice(N_USERS, n, replace=False)
        ms = {m: cuda_median_ms(lambda: srv.recommend_async(uids, TOP_K, m))
              for m in METHODS}
        phase("serve_latency", users=n,
              **{f"{m}_ms": f"{t:.4f}" for m, t in ms.items()})


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

    max_err, times = kernel_cases(dev)
    tk, tp = times[(8192, "fp32")]
    k2_err, k2_times = k2_cases(dev)
    k2_ms, k2_plain_ms = k2_times[(256, "bf16")]  # recommend's shape
    hybrid_cases(dev)

    root = tempfile.mkdtemp(prefix=".smoke_", dir=ROOT)
    try:
        launches, count_launches, (pu, pi) = main_path(dev, root)
        if launches <= 0 or count_launches <= 0:
            raise AssertionError("the main path never launched K1 or K2")
        floor_err, floor_plain_ms = floor_cases(dev)
        floor_launches, floor_ms = floor_path(dev)
        if floor_launches <= 0:
            raise AssertionError("the floor probe never launched P1")
        t_launches, t_count_launches = train_path(dev, root, pu, pi)
        if t_launches <= 0 or t_count_launches <= 0:
            raise AssertionError("the trained tables never went through K1 "
                                 "or K2")
        train_rate(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches += t_launches
    count_launches += t_count_launches

    print(json.dumps({"kernels": [{
        "name": "topk_fused",
        "route": "cuda",
        "source": "topk_rec_torch/csrc/topk_fused.cu",
        "replaces": "topk_rec_tpu/ops/topk_pallas.py:119",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": tk,
        "plain_ms": tp,
    }, {
        "name": "topk_count",
        "route": "cuda",
        "source": "topk_rec_torch/csrc/topk_count.cu",
        "replaces": "topk_rec_tpu/ops/topk_hybrid.py:55",
        "launches": count_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
    }, {
        "name": "topk_floor",
        "route": "cuda",
        "source": "topk_rec_torch/csrc/topk_floor.cu",
        "replaces": "benchmarks/probe_topk_floor.py:44",
        "launches": floor_launches,
        "max_abs_err": floor_err,
        "ms": floor_ms,
        "plain_ms": floor_plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
