"""Iteration traffic: a closed loop of whole ``CER.train`` calls on the
seeded fold.

Set-up makes the fold and the item features from the seed, and builds the
model as ``train --model cer`` builds it (``cli.build_model``), its seed
drawn from the run's seed: the uniform initial U and V are the model's
own draws, and E the standard normal draw ``CER.train`` makes when none is
given. The fold and the features reach it through ``set_interactions`` and
``set_features``. Every call starts from those tables again (``restart``
"initial"): ``train`` replaces them with its results, so each call does
the same arithmetic.

Set-up's call, ``CER.train(max_iter, tol, verbose=False)`` with a
``state.log``, warms every shape and is the call the check follows: its
losses, U, V (after the cold-start write-back) and E, and the route of
each E-solve, are kept. The window then runs calls until ``--seconds``
have passed, each ending with the tables read back to the host.
``train_samples_per_s`` is the fold's training pairs times the
iterations of the window's calls over the window's time. After it,
``profile_calls`` more calls run under the profiler (the host's
operations and launches only in a traced run) for the per-layer metrics,
and the float64 reference runs from the same tables.

The E-solves are observed through a wrapper of the model's ``_solve_E``
that reads, after each, the CG steps it took and whether it was the
direct fallback; it changes nothing the solve does.

The traffic file's keys: ``max_iter``, ``tol``, ``restart``,
``profile_calls``."""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
from typing import List

import numpy as np
import torch

from .. import checks_iterate
from ..checks_iterate import Call, Initial
from ..fold import make_features, make_fold
from ..launch_trace import profiled
from ..opcount_cer import call_flops, esolve_bound_s
from ..result import Outcome
from ..seeds import stream_seed


def build_model(cfg: dict, fold, feat: np.ndarray, seed: int, device):
    """The program's model as the CLI builds it, on the fold and the
    features."""
    from topk_rec_torch.cli import build_model as cli_model
    from topk_rec_torch.config import ModelConfig
    from topk_rec_torch.data import Interactions

    mc = ModelConfig(model=cfg["model"], k=cfg["k"], d=cfg["d"],
                     als_lu=cfg["lu"], als_lv=cfg["lv"], als_le=cfg["le"],
                     als_a=cfg["a"], als_b=cfg["b"],
                     seed=stream_seed(seed, "tables"))
    model = cli_model(mc, device)
    if model.block_size != cfg["block_size"]:
        raise ValueError(f"the CLI's model solves blocks of "
                         f"{model.block_size}, the configuration states "
                         f"{cfg['block_size']}")
    model.set_interactions(Interactions(fold.n_users, fold.n_items,
                                        fold.train_u.astype(np.int32),
                                        fold.train_i.astype(np.int32)))
    model.set_features(feat)
    return model


class Observer:
    """Reads the CG steps and the route of each E-solve of the model."""

    def __init__(self, model):
        self.steps: List[int] = []
        self.direct: List[int] = []
        solve = model._solve_E

        def observed(Y):
            E = solve(Y)
            self.steps.append(int(model.e_solver_steps))
            self.direct.append(int(bool(model._e_solver_use_direct)))
            return E

        model._solve_E = observed

    def reset(self) -> None:
        self.steps, self.direct = [], []


def initial_tables(model) -> Initial:
    """The tables every call starts from, read-only: U and V as the model
    drew them, E as ``CER.train`` draws it when none is given."""
    E = np.random.default_rng(model.seed + 17).standard_normal(
        (model.d, model.k)).astype(np.float32)
    init = Initial(model.fue, model.fie, E)
    for t in (init.U, init.V, init.E):
        t.flags.writeable = False
    return init


def run_call(model, obs: Observer, init: Initial, traffic: dict,
             log_dir=None) -> None:
    """One call of ``CER.train`` from the initial tables."""
    model.fue, model.fie, model.E = init.U, init.V, init.E
    obs.reset()
    model.train(max_iter=traffic["max_iter"], tol=traffic["tol"],
                verbose=False, log_dir=log_dir)


def checked_call(model, obs: Observer, init: Initial, traffic: dict) -> Call:
    """Set-up's call, with its losses read from ``state.log``."""
    log_dir = tempfile.mkdtemp(prefix="portbench-iterate-")
    try:
        run_call(model, obs, init, traffic, log_dir)
        with open(os.path.join(log_dir, "state.log")) as f:
            losses = [float(r.split()[2]) for r in f.read().splitlines()[1:]]
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    return Call(losses, model.fue.copy(), model.fie.copy(), model.E.copy(),
                list(obs.steps), sum(obs.direct))


def setup(cfg: dict, traffic: dict, seed: int, device):
    """(fold, host features, model, observer, initial tables, the checked
    call)."""
    if traffic["restart"] != "initial":
        raise ValueError(f"unknown restart {traffic['restart']!r}")
    fold = make_fold(cfg, seed, device)
    feat = make_features(cfg, seed, device).cpu().numpy()
    model = build_model(cfg, fold, feat, seed, device)
    obs = Observer(model)
    init = initial_tables(model)
    call = checked_call(model, obs, init, traffic)
    return fold, feat, model, obs, init, call


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> Outcome:
    on_card = torch.device(device).type == "cuda"
    fold, feat, model, obs, init, call = setup(cfg, traffic, seed, device)
    n_iter = traffic["max_iter"]
    pairs = int(fold.train_u.size)
    shape = (pairs, fold.n_users, fold.n_items, cfg["d"], cfg["k"])
    sync(device)

    t0 = time.perf_counter()
    setup_s = t0 - t_start
    calls, failed, flops = 0, 0, 0.0
    while True:
        run_call(model, obs, init, traffic)
        calls += 1
        flops += call_flops(*shape, obs.steps, obs.direct)
        if not (np.isfinite(model.fie).all() and np.isfinite(model.E).all()):
            failed += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    elapsed = time.perf_counter() - t0
    rate = pairs * n_iter * calls / elapsed

    # after the window, in every run: ``profile_calls`` calls profiled,
    # the host's operations and the launches only in a traced run
    n_prof = traffic["profile_calls"]
    bound, steps, direct = 0.0, 0, 0

    def stretch():
        nonlocal bound, steps, direct
        for _ in range(n_prof):
            run_call(model, obs, init, traffic)
            n, d, k = fold.n_items, cfg["d"], cfg["k"]
            bound += sum(esolve_bound_s(n, d, k, s, x)
                         for s, x in zip(obs.steps, obs.direct))
            steps += sum(obs.steps)
            direct += sum(obs.direct)

    tr = profiled("iterate", stretch, device, host_ops=trace)
    tr.counts = {"calls": n_prof, "iterations": n_prof * n_iter,
                 "cg_steps": steps, "direct_solves": direct,
                 "esolve_bound_s": bound}
    tr.window = {"samples_per_s": rate, "s_per_call": elapsed / calls,
                 "flops_per_s": flops / elapsed}
    metrics = {"train_samples_per_s": rate, "setup_s": setup_s}
    print(f"window: {calls} calls in {elapsed:.4f} s; profiled: "
          f"{steps} CG steps, {direct} direct solves, busy "
          f"{tr.busy_s():.4f} s in {tr.wall_s:.4f} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del model, obs
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = checks_iterate.reference(cfg, fold, torch.from_numpy(feat), init,
                                   n_iter, device)
    found = checks_iterate.iterate(cfg, call, ref)
    return Outcome(metrics=metrics, attempted=calls, failed=failed,
                   checks=found, memory_peak_bytes=peak,
                   trace=tr if trace else None)
