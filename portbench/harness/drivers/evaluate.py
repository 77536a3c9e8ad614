"""Evaluation traffic: the reference's protocol, ``evaluate`` over and over.

Set-up makes the fold and the tables (U, V ~ N(0, 0.3²), a bias
~ N(0, 0.1²), six decimals) from the seed and writes them in the
reference's text formats into a directory under ``TMPDIR``, removed at
the end of the run. Each call is ``topk_rec_torch.cli.main(["evaluate",
...])`` in this process, on every scenario of the traffic at the default
step and total, on the ``engine`` of the traffic; its printed lines are
kept and compared with the reference's after the window. One call in
set-up builds what the program builds at first use. The window runs whole
calls until ``--seconds`` have passed. In a traced run the program's own
phase times (``TKR_TIMING=1``, on its standard error) are read from every
call of the window, and one more call is profiled.

The traffic file's keys: ``scenarios``, ``engine``, ``step``, ``total``,
``user_chunk``."""

from __future__ import annotations

import contextlib
import gc
import io
import os
import re
import shutil
import tempfile
import time
from collections import defaultdict

import torch

from .. import checks
from ..fold import make_fold, make_tables, round6, write_dat, write_fold_text
from ..opcount import k1_bound_s, score_flops
from ..result import Outcome
from ..trace import profiled

TIMING = re.compile(r"^timing: (\S+) ([0-9.]+)s$")


def write_inputs(cfg: dict, seed: int, device, root: str):
    """The fold's text files in ``root`` and the tables in
    ``root/model``; returns the fold and the tables as float32 arrays."""
    fold = make_fold(cfg, seed, device)
    U, V, B = (round6(t.cpu().numpy()) for t in
               make_tables(fold.n_users, fold.n_items, cfg["k"], seed,
                           device))
    write_fold_text(fold, root)
    mdir = os.path.join(root, "model")
    os.makedirs(mdir)
    for name, mat in (("U", U), ("V", V), ("B", B)):
        write_dat(os.path.join(mdir, f"final-{name}.dat"), mat)
    return fold, (U, V, B)


def call(root: str, traffic: dict, device, timing: bool):
    """One ``evaluate``: (its printed lines, its phase times)."""
    from topk_rec_torch.cli import main

    argv = ["evaluate", "-d", root, "-m", os.path.join(root, "model"),
            "-f", "0", "-sl", *traffic["scenarios"],
            "-s", str(traffic["step"]), "-t", str(traffic["total"]),
            "--user-chunk", str(traffic["user_chunk"]),
            "--engine", traffic["engine"], "--device", str(device)]
    out, err = io.StringIO(), io.StringIO()
    old = os.environ.get("TKR_TIMING")
    os.environ["TKR_TIMING"] = "1" if timing else "0"
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        if old is None:
            del os.environ["TKR_TIMING"]
        else:
            os.environ["TKR_TIMING"] = old
    spans = {}
    for ln in err.getvalue().splitlines():
        m = TIMING.match(ln.strip())
        if m:
            spans[m.group(1)] = float(m.group(2))
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    return rc, lines, spans


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float) -> Outcome:
    on_card = torch.device(device).type == "cuda"
    root = tempfile.mkdtemp(prefix="portbench-fold-")
    try:
        fold, tables = write_inputs(cfg, seed, device, root)
        call(root, traffic, device, False)  # first use: builds, warms

        printed, spans, failed, n = [], defaultdict(float), 0, 0
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        while True:
            rc, lines, sp = call(root, traffic, device, trace)
            n += 1
            if rc != 0 or len(lines) != len(traffic["scenarios"]):
                failed += 1
            printed.append(lines)
            for name, s in sp.items():
                spans[name] += s
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0

        tr = None
        if trace:
            tr = profiled("evaluate", lambda: call(root, traffic, device,
                                                   False), device)
            tr.counts = {"folds": 1, "k1_bound_s": eval_k1_bound(
                cfg, fold, traffic)}
            names = traffic["scenarios"]
            tr.window = {
                "s_per_fold": elapsed / n,
                "parse_s": (spans["fold_parse"] + spans["dat_parse"]
                            + sum(spans[f"{s}_inputs"] for s in names)) / n,
                "score_s": sum(spans[f"{s}_eval"] for s in names) / n,
                "flops_per_fold": sum(
                    score_flops(fold.n_users, fold.scenario(s)[0].size,
                                cfg["k"]) for s in names)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = checks.reference_lines(fold, *tables, traffic["scenarios"],
                                 traffic["step"], traffic["total"], "fp32",
                                 device)
    return Outcome(metrics={"eval_s_per_fold": elapsed / n,
                            "setup_s": setup_s},
                   attempted=n, failed=failed,
                   checks=checks.evaluate(cfg, printed, ref),
                   memory_peak_bytes=peak, trace=tr)


def eval_k1_bound(cfg: dict, fold, traffic: dict) -> float:
    """K1's bound over one call, counting what the protocol needs: each
    scenario's user chunks against that scenario's candidates. (The
    program hands K1 the whole catalog and excludes the rest by bits;
    that work is not counted.)"""
    chunk, total = traffic["user_chunk"], traffic["total"]
    return sum(k1_bound_s(min(chunk, fold.n_users - lo),
                          fold.scenario(s)[0].size, cfg["k"], total,
                          exact=True)
               for s in traffic["scenarios"]
               for lo in range(0, fold.n_users, chunk))
