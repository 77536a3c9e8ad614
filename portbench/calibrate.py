"""Readings that the limits of a cell's compared numbers are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 12 \
        --first-seed <n> [--controls 3] [--faults 3] [--out FILE]

runs, at the cell's own size and without a measured window (training: the
first chunk of the window's shape, as a run checks it), the program
on ``--seeds`` seeds (the lower readings), the control on the first
``--controls`` of them, and each fault of ``portbench/faults.py`` on the
first ``--faults`` (the upper readings). The control is the plain
reference put in the program's place, in the float type just below the
one the configuration states: bfloat16 for training's float32, float8
e4m3 for serving's bf16 tables, TF32 for evaluation's float32 products.
Each reading is one JSON line; the last line sums them up: the largest
program reading and the smallest control and fault readings of each
number."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import torch  # noqa: E402

from portbench import faults  # noqa: E402
from portbench.harness import checks, manifest  # noqa: E402
from portbench.harness.drivers import evaluate, serve, train  # noqa: E402
from portbench.reference import pairwise, topk  # noqa: E402

SERVE_BATCHES = 512  # served batches compared per seed, about a run's


def train_case(cfg, traffic, seed, device, fault=None):
    ctx = fault() if fault else contextlib.nullcontext()
    with ctx:
        fold, init, feat, model, _, warm = train.setup(cfg, traffic, seed,
                                                       device)
    del model
    nums = {"bad_triplets": float(checks.bad_triplets(fold, warm.triplets,
                                                      device))}
    found, dropped = checks.train_numbers(cfg, init, feat, warm,
                                          device=device)
    nums.update(found)
    return nums, dropped, (fold, init, feat, warm)


def train_control(cfg, state, device):
    """The reference in bfloat16 in the program's place, on the program's
    triplets."""
    fold, init, feat, warm = state
    u, i, j = warm.triplets
    losses, params, ms = pairwise.run_steps(
        cfg["model"], {n: t.to(device) for n, t in init.items()},
        list(zip(u, i, j)), checks.hyper(cfg), torch.bfloat16,
        None if feat is None else feat)
    ctrl = train.Warmup(warm.triplets, sum(losses),
                        {n: p.float() for n, p in params.items()},
                        {n: m.float() for n, m in ms.items()})
    return checks.train_numbers(cfg, init, feat, ctrl, device=device)[0]


def served(server, pool, traffic, n):
    k, method = traffic["k"], traffic["method"]
    out = []
    for q in range(n):
        uids = pool[q % pool.shape[0]]
        vals, ids = server.recommend(uids, k=k, method=method)
        out.append((uids, ids, vals))
    return out


def serve_cases(cfg, traffic, seed, device, control, fault_list):
    fold, (U, V, B), server, pool = serve.setup(cfg, traffic, seed, device)
    served(server, pool, traffic, traffic["warmup_batches"])
    k = traffic["k"]
    out = {"program": checks.serve_numbers(
        fold, U, V, B, served(server, pool, traffic, SERVE_BATCHES), k,
        "bf16", device)}
    for name, fault in fault_list:
        with fault():
            got = served(server, pool, traffic, SERVE_BATCHES)
        out[name] = checks.serve_numbers(fold, U, V, B, got, k, "bf16",
                                         device)
    if control:
        indptr, items = checks.user_csr(fold, device)
        lists = []
        for q in range(SERVE_BATCHES):
            uids = pool[q % pool.shape[0]]
            users = torch.as_tensor(uids, device=device)
            s = topk.scores(U, V, B, users, "fp8")
            vals, ids = topk.topk_unseen(
                s, topk.seen_rows(indptr, items, users, fold.n_items), k)
            lists.append((uids, ids.cpu().numpy(), vals.cpu().numpy()))
        out["control"] = checks.serve_numbers(fold, U, V, B, lists, k,
                                              "bf16", device)
    return out


def evaluate_cases(cfg, traffic, seed, device, control, fault_list):
    root = tempfile.mkdtemp(prefix="portbench-calibrate-")
    try:
        fold, tables = evaluate.write_inputs(cfg, seed, device, root)
        evaluate.call(root, traffic, device, False)
        ref = checks.reference_lines(fold, *tables, traffic["scenarios"],
                                     traffic["step"], traffic["total"],
                                     "fp32", device)
        _, lines, _ = evaluate.call(root, traffic, device, False)
        out = {"program": {"acc_off": checks.acc_off(lines, ref)}}
        print(json.dumps({"seed": seed, "lines": lines,
                          "reference": list(ref.values())}), flush=True)
        for name, fault in fault_list:
            with fault():
                _, got, _ = evaluate.call(root, traffic, device, False)
            out[name] = {"acc_off": checks.acc_off(got, ref)}
        if control:
            tf = checks.reference_lines(fold, *tables, traffic["scenarios"],
                                        traffic["step"], traffic["total"],
                                        "tf32", device)
            out["control"] = {"acc_off": checks.acc_off(list(tf.values()),
                                                        ref)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def readings(cell, seeds, controls, n_faults, device, emit):
    man = manifest.load()
    inp = manifest.cell_inputs(man, cell)
    cfg, traffic = inp["config"], inp["traffic"]
    kind = traffic["kind"]
    fault_map = faults.faults(kind, cfg["model"])
    for n, seed in enumerate(seeds):
        fl = list(fault_map.items()) if n < n_faults else []
        if kind == "train":
            nums, dropped, state = train_case(cfg, traffic, seed, device)
            emit(cell, seed, "program", nums)
            print(json.dumps({"seed": seed, "change_gap_leaves_out":
                              dropped}), flush=True)
            if n < controls:
                emit(cell, seed, "control", train_control(cfg, state, device))
            del state
            for name, fault in fl:
                emit(cell, seed, name,
                     train_case(cfg, traffic, seed, device, fault)[0])
        else:
            case = serve_cases if kind == "serve" else evaluate_cases
            for variant, nums in case(cfg, traffic, seed, device,
                                      n < controls, fl).items():
                emit(cell, seed, variant, nums)
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None):
    p = argparse.ArgumentParser(prog="portbench/calibrate.py")
    p.add_argument("--workload", required=True, nargs="+")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    table = defaultdict(list)
    sink = open(args.out, "a") if args.out else None

    def emit(cell, seed, variant, nums):
        rec = {"cell": cell, "seed": seed, "variant": variant,
               "numbers": nums}
        print(json.dumps(rec), flush=True)
        if sink:
            sink.write(json.dumps(rec) + "\n")
            sink.flush()
        for k, v in nums.items():
            table[(cell, variant, k)].append(v)

    seeds = [args.first_seed + 7919 * n for n in range(args.seeds)]
    for cell in args.workload:
        readings(cell, seeds, args.controls, args.faults, device, emit)
    summary = {}
    for (cell, variant, k), vals in sorted(table.items()):
        key = f"{cell}/{variant}/{k}"
        summary[key] = max(vals) if variant == "program" else min(vals)
    print(json.dumps({"summary": summary}), flush=True)
    if sink:
        sink.write(json.dumps({"summary": summary}) + "\n")
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
