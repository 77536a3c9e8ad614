"""Command-line interface of the port: ``evaluate`` and ``recommend``.

Counterpart of ``topk_rec_tpu/cli.py:66-179, 494-675``, with the same
flags plus ``--device`` (default ``cuda``; there is no silent fallback to
the CPU). The backends are named for this package: ``--engine
{torch,kernel}`` stands for JAX's ``{xla,pallas}`` and ``--method
{exact,approx,kernel,hybrid}`` for ``{exact,approx,pallas,hybrid}``; both
default to ``kernel``, the fused CUDA kernel. Folds and ``.dat`` files are
read by the shared ``topk_rec_tpu.data``, so the CSV lines match
``topk_rec_tpu.cli``.

Usage:
  python -m topk_rec_torch.cli evaluate -d data -m embed/bpr -f 0 -sl im om
  python -m topk_rec_torch.cli recommend -d data -m embed/bpr -k 30 u1 u2
  python -m topk_rec_torch.cli recommend ... --method hybrid u1 u2
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from topk_rec_tpu.config import EvalConfig
from topk_rec_tpu.data import Interactions, load_id_map, read_dat

from .eval.protocol import load_test_likes

_EC = EvalConfig()


def _load_fold(data_dir: str, fold: int):
    uids = load_id_map(os.path.join(data_dir, "uid"))
    iids = load_id_map(os.path.join(data_dir, "vid"))
    inter, _, _ = Interactions.from_files(
        os.path.join(data_dir, "uid"),
        os.path.join(data_dir, "vid"),
        os.path.join(data_dir, f"f{fold}tr.txt"),
    )
    return inter, uids, iids


def _scenario_inputs(data_dir: str, fold: int, scenario: str, uids, iids):
    idl = os.path.join(data_dir, f"f{fold}te.{scenario}.idl")
    txt = os.path.join(data_dir, f"f{fold}te.{scenario}.txt")
    cand_map = load_id_map(idl)
    cand_ids = np.empty(len(cand_map), dtype=np.int64)
    for cid, pos in cand_map.items():
        cand_ids[pos] = iids[cid]
    likes = load_test_likes(txt, uids, cand_map)
    return cand_ids, likes


def _fail(msg: str) -> "SystemExit":
    """Message on stderr, exit code 2, no traceback (cli.py:88-93)."""
    print(f"error: {msg}", file=sys.stderr)
    return SystemExit(2)


def _read_model_mat(mdir: str, name: str, ids) -> np.ndarray:
    path = os.path.join(mdir, name)
    if not os.path.isdir(mdir):
        raise _fail(
            f"model directory {mdir!r} does not exist — expected a "
            f"directory holding final-U.dat / final-V.dat "
            f"(train + export first)"
        )
    if not os.path.exists(path):
        raise _fail(
            f"{path!r} not found — the model directory must contain "
            f"final-U.dat and final-V.dat (optional final-B.dat)"
        )
    try:
        return read_dat(path, ids)
    except ValueError as e:
        raise _fail(str(e))


def _read_model(mdir: str, uids, iids):
    umat = _read_model_mat(mdir, "final-U.dat", uids)
    vmat = _read_model_mat(mdir, "final-V.dat", iids)
    bmat = (
        _read_model_mat(mdir, "final-B.dat", iids).reshape(-1)
        if os.path.exists(os.path.join(mdir, "final-B.dat"))
        else None
    )
    return umat, vmat, bmat


def _device(name: str):
    from .device import resolve_device

    try:
        return resolve_device(name)
    except (RuntimeError, ValueError) as e:
        raise _fail(str(e))


def cmd_evaluate(args) -> int:
    from .eval.device import DeviceEvaluator

    device = _device(args.device)
    inter, uids, iids = _load_fold(args.data, args.fold)
    umat, vmat, bmat = _read_model(args.model, uids, iids)
    ev = DeviceEvaluator(
        inter.seen_bitmap, step=args.step, total=args.total,
        user_chunk=args.user_chunk, use_kernel=args.engine == "kernel",
        want_rr=False,  # the CSV prints accuracy only (ref evaluate.py:113-117)
        device=device,
    )
    for scenario in args.scenarios:
        cand_ids, likes = _scenario_inputs(
            args.data, args.fold, scenario, uids, iids
        )
        res = ev.evaluate(umat, vmat, bmat, cand_ids, likes)
        print(scenario + "".join(",%.6f" % a for a in res.accuracy))
    return 0


def cmd_recommend(args) -> int:
    """Top-k unseen items per requested user, one CSV line each:
    ``user_id,item_id:score,...`` (cli.py:494-541)."""
    from .serving import TopKServer

    device = _device(args.device)
    inter, uids, iids = _load_fold(args.data, args.fold)
    umat, vmat, bmat = _read_model(args.model, uids, iids)
    raw_users = list(args.users or [])
    if args.users_file:
        with open(args.users_file) as f:
            raw_users += [ln.strip() for ln in f if ln.strip()]
    if not raw_users:
        raise _fail("no users given — pass ids as arguments or --users-file")
    missing = [u for u in raw_users if u not in uids]
    if missing:
        raise _fail(
            f"unknown user id(s): {', '.join(missing[:5])}"
            + (" ..." if len(missing) > 5 else "")
        )
    inv_items = {v: k for k, v in iids.items()}
    srv = TopKServer(
        umat, vmat, bmat, inter, exclude_seen=not args.include_seen,
        device=device,
    )
    idx = np.array([uids[u] for u in raw_users], dtype=np.int64)
    vals, items = srv.recommend(idx, k=args.k, method=args.method)
    for row, u in enumerate(raw_users):
        cells = [
            f"{inv_items[int(i)]}:{float(v):.6f}"
            for v, i in zip(vals[row], items[row])
            if np.isfinite(v)
        ]
        print(u + "," + ",".join(cells))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="topk_rec_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("evaluate", help="evaluate exported .dat embeddings")
    pe.add_argument("-d", "--data", required=True)
    pe.add_argument("-m", "--model", required=True)
    pe.add_argument("-f", "--fold", type=int, default=_EC.fold)
    pe.add_argument("-s", "--step", type=int, default=_EC.step)
    pe.add_argument("-t", "--total", type=int, default=_EC.total)
    pe.add_argument("-sl", "--scenarios", nargs="+", default=_EC.scenarios)
    pe.add_argument("--user-chunk", type=int, default=_EC.user_chunk)
    pe.add_argument("--engine", default="kernel", choices=("torch", "kernel"),
                    help="scoring+top-k backend: torch matmul + stable sort, "
                    "or the fused CUDA kernel — identical output")
    pe.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    pe.set_defaults(func=cmd_evaluate)

    pr = sub.add_parser(
        "recommend", help="top-k unseen items for given users (serving)"
    )
    pr.add_argument("-d", "--data", required=True)
    pr.add_argument("-m", "--model", required=True)
    pr.add_argument("-f", "--fold", type=int, default=0)
    pr.add_argument("-k", type=int, default=30)
    pr.add_argument("--method", default="kernel",
                    choices=("exact", "approx", "kernel", "hybrid"),
                    help="exact: matmul + stable sort; approx: approximate "
                    "(recall ~0.95); kernel: the fused CUDA kernel; hybrid: "
                    "approx repaired to exact by a count audit")
    pr.add_argument("--include-seen", action="store_true",
                    help="do not exclude train-seen items")
    pr.add_argument("--users-file", default=None,
                    help="file with one user id per line")
    pr.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    pr.add_argument("users", nargs="*", help="user ids (as in the uid file)")
    pr.set_defaults(func=cmd_recommend)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
