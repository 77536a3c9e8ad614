"""Readings that the limits of an ``iterate`` cell's compared numbers are
set from.

    python3 portbench/calibrate_iterate.py --workload <cell> --seeds 12 \
        --first-seed <n> [--controls 3] [--faults 3] [--out FILE]

runs, at the cell's own size and without a measured window, set-up's
checked call of ``CER.train`` on ``--seeds`` seeds (the lower readings),
the control on the first ``--controls`` of them, and each fault of
``portbench/faults_iterate.py`` on the first ``--faults`` (the upper
readings), each held to the float64 reference from the same tables. The
control is the plain reference in the program's place with its tables
held in bfloat16, the type below the configuration's float32. Each
reading is one JSON line; the last sums them up: the largest program
reading and the smallest control and fault readings of each number. The
E-solves' CG steps of each call are printed too."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

import torch  # noqa: E402

from portbench import faults_iterate  # noqa: E402
from portbench.harness import checks_iterate, manifest  # noqa: E402
from portbench.harness.drivers import iterate  # noqa: E402
from portbench.reference.precision import bf16  # noqa: E402


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def readings(cell, seeds, controls, n_faults, device, emit):
    inp = manifest.cell_inputs(manifest.load(), cell)
    cfg, traffic = inp["config"], inp["traffic"]
    n_iter = traffic["max_iter"]
    for n, seed in enumerate(seeds):
        fold, feat, model, _, init, call = iterate.setup(cfg, traffic, seed,
                                                         device)
        del model
        free(device)
        ref = checks_iterate.reference(cfg, fold, torch.from_numpy(feat),
                                       init, n_iter, device)
        emit(cell, seed, "program", checks_iterate.numbers(call, ref),
             call.steps)
        if n < controls:
            c = checks_iterate.reference(cfg, fold, torch.from_numpy(feat),
                                         init, n_iter, device,
                                         state_rounding=bf16)
            ctrl = checks_iterate.Call(c[0], *(t.float().cpu().numpy()
                                               for t in c[1:]), [], 0)
            emit(cell, seed, "control", checks_iterate.numbers(ctrl, ref),
                 [])
        if n < n_faults:
            for name, fault in faults_iterate.faults().items():
                with fault():
                    model = iterate.build_model(cfg, fold, feat, seed,
                                                device)
                    obs = iterate.Observer(model)
                    got = iterate.checked_call(model, obs, init, traffic)
                del model, obs
                free(device)
                emit(cell, seed, name, checks_iterate.numbers(got, ref),
                     got.steps)
        del ref
        free(device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="portbench/calibrate_iterate.py")
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

    def emit(cell, seed, variant, nums, steps):
        rec = {"cell": cell, "seed": seed, "variant": variant,
               "numbers": nums, "cg_steps": steps}
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
