"""Serving traffic: one caller in a closed loop of ``TopKServer.recommend``.

Set-up makes the fold and the tables (U, V ~ N(0, 0.3²), a bias
~ N(0, 0.1²)) from the seed and builds the server as ``recommend`` builds
it: the fold's seen items excluded. Each request asks for the top ``k``
items of ``batch_users`` distinct users, drawn uniformly from a pool of
``request_pool`` requests made from the seed; a batch's latency runs from
the call to the results in host memory. A sample of the requests, drawn
from the seed (each with probability ``1 / check_every``), is kept and
compared with the reference once the window has closed.

The traffic file's keys: ``batch_users``, ``k``, ``method``,
``request_pool``, ``check_every``, ``warmup_batches``,
``profile_batches``."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from .. import checks
from ..fold import make_fold, make_tables
from ..opcount import k1_bound_s
from ..result import Outcome
from ..seeds import rng
from ..trace import profiled

MAX_BATCHES = 1 << 21  # the most requests a window is given a sample flag


def request_pool(n_users: int, traffic: dict, seed: int) -> np.ndarray:
    """[request_pool, batch_users] distinct user ids per request."""
    r = rng(seed, "requests")
    b = traffic["batch_users"]
    pool = np.empty((traffic["request_pool"], b), np.int64)
    for q in range(pool.shape[0]):
        while True:
            draw = r.integers(0, n_users, size=b + b // 4 + 16)
            uniq, first = np.unique(draw, return_index=True)
            if uniq.size >= b:
                pool[q] = draw[np.sort(first)[:b]]
                break
    return pool


def setup(cfg: dict, traffic: dict, seed: int, device):
    from topk_rec_torch.data import Interactions
    from topk_rec_torch.serving import TopKServer

    fold = make_fold(cfg, seed, device)
    inter = Interactions(fold.n_users, fold.n_items,
                         fold.train_u.astype(np.int32),
                         fold.train_i.astype(np.int32))
    U, V, B = make_tables(fold.n_users, fold.n_items, cfg["k"], seed, device)
    server = TopKServer(U, V, B, inter, exclude_seen=True, device=device)
    return fold, (U, V, B), server, request_pool(fold.n_users, traffic, seed)


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> Outcome:
    on_card = torch.device(device).type == "cuda"
    k, method = traffic["k"], traffic["method"]
    fold, (U, V, B), server, pool = setup(cfg, traffic, seed, device)
    keep = rng(seed, "sample").random(MAX_BATCHES) < 1.0 / traffic[
        "check_every"]
    keep[0] = True  # at least one batch is compared
    n_pool = pool.shape[0]
    for q in range(traffic["warmup_batches"]):
        server.recommend(pool[q % n_pool], k=k, method=method)

    kept, failed, n = [], 0, 0
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        uids = pool[n % n_pool]
        vals, ids = server.recommend(uids, k=k, method=method)
        if not np.isfinite(vals).all():
            failed += 1
        if keep[n % MAX_BATCHES]:
            kept.append((uids, ids, vals))
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0

    tr = None
    if trace:
        n_prof = traffic["profile_batches"]

        def stretch():
            for q in range(n_prof):
                server.recommend(pool[(n + q) % n_pool], k=k, method=method)

        tr = profiled("serve", stretch, device)
        b, d = traffic["batch_users"], cfg["k"]
        tr.counts = {"batches": n_prof,
                     "k1_bound_s": n_prof * k1_bound_s(b, fold.n_items, d, k,
                                                       exact=False),
                     "flops_per_batch": 2.0 * b * fold.n_items * d}
        tr.window = {"s_per_batch": elapsed / n}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del server
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    found = checks.serve(cfg, fold, U, V, B, kept, k, device)
    return Outcome(metrics={"serve_batch_ms": elapsed / n * 1e3,
                            "setup_s": setup_s},
                   attempted=n, failed=failed, checks=found,
                   memory_peak_bytes=peak, trace=tr)
