"""Command-line interface of the port: ``train``, ``evaluate``, ``fuse``
and ``recommend``.

Counterpart of ``topk_rec_tpu/cli.py``, with the same flags plus
``--device`` (default ``cuda``; there is no silent fallback to the CPU).
``train`` takes ``--model bpr|vbpr|wmf|cer|dpm`` and, for a run over a
mesh of ranks (``parallel/``), ``--mesh auto|DPxMP``, ``--exchange`` and,
for several processes, ``--coordinator``, ``--num-processes`` and
``--process-id``. The backends are named for this
package: ``--engine {torch,kernel}`` stands for JAX's ``{xla,pallas}`` and
``--method {exact,approx,kernel,hybrid}`` for
``{exact,approx,pallas,hybrid}``; both default to ``kernel``, the fused
CUDA kernel. Folds and ``.dat`` files are
read by the port's own ``data`` package, the same parser as
``topk_rec_tpu.data``, so the CSV lines match ``topk_rec_tpu.cli``.

Usage:
  python -m topk_rec_torch.cli train --model bpr -d data -o embed/bpr
  python -m topk_rec_torch.cli train --model bpr -d data -o embed/bpr \
      --mesh 1x2 --coordinator host:port --num-processes 2 --process-id 0
  python -m topk_rec_torch.cli train --model cer -d data -o embed/cer \
      --content meta.pkl --d 20000 --log-dir embed/cer
  python -m topk_rec_torch.cli train --model dpm -d data -o embed/dpm \
      --content meta.pkl --d 20000 --encoder sdae --max-iter 20
  python -m topk_rec_torch.cli fuse --strategy rank -d data \
      -m embed/cer embed/dpm -sl im om
  python -m topk_rec_torch.cli evaluate -d data -m embed/bpr -f 0 -sl im om
  python -m topk_rec_torch.cli recommend -d data -m embed/bpr -k 30 u1 u2
  python -m topk_rec_torch.cli recommend ... --method hybrid u1 u2
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from typing import List, Optional

import numpy as np

from .config import (
    DataConfig,
    EvalConfig,
    ModelConfig,
    TrainConfig,
)
from .data import Interactions, load_id_map, read_dat
from .eval.protocol import load_test_likes
from .tracing import recording, span
from .utils import tprint

_EC = EvalConfig()
_MC = ModelConfig()
_TC = TrainConfig()
MODELS = ("bpr", "vbpr", "wmf", "cer", "dpm")  # the JAX CLI's choices
PORTED_MODELS = ("bpr", "vbpr", "wmf", "cer", "dpm")
CONTENT_MODELS = ("vbpr", "cer", "dpm")
ENCODERS = ("mlp", "sdae")
EVALUATE = "evaluate."  # the prefix of the spans of evaluate's phases


def _load_fold(data_dir: str, fold: int):
    return Interactions.from_files(
        os.path.join(data_dir, "uid"),
        os.path.join(data_dir, "vid"),
        os.path.join(data_dir, f"f{fold}tr.txt"),
    )


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


def build_model(mc: ModelConfig, device, mesh=None):
    """The configured model on ``device`` (cli.py:182-215); WMF, CER and DPM
    route their sweeps through ``mesh`` when one is given."""
    from .models import BPR, CER, DPM, VBPR, WMF

    if mc.model == "bpr":
        return BPR(
            k=mc.k, lambda_u=mc.lambda_u, lambda_i=mc.lambda_i,
            lambda_j=mc.lambda_j, lambda_b=mc.lambda_b, lr=mc.lr,
            mode=mc.mode, seed=mc.seed, membership=mc.membership,
            device=device,
        )
    if mc.model == "vbpr":
        return VBPR(
            k=mc.k, d=mc.d, lambda_u=mc.lambda_u, lambda_i=mc.lambda_i,
            lambda_j=mc.lambda_j, lambda_b=mc.lambda_b,
            lambda_e=mc.lambda_e, lr=mc.lr, mode=mc.mode, seed=mc.seed,
            membership=mc.membership, device=device,
        )
    if mc.model == "wmf":
        return WMF(k=mc.k, lu=mc.als_lu, lv=mc.als_lv, a=mc.als_a,
                   b=mc.als_b, seed=mc.seed, device=device, mesh=mesh)
    if mc.model == "cer":
        return CER(k=mc.k, d=mc.d, lu=mc.als_lu, lv=mc.als_lv, le=mc.als_le,
                   a=mc.als_a, b=mc.als_b, seed=mc.seed, device=device,
                   mesh=mesh)
    if mc.model == "dpm":
        return DPM(k=mc.k, d=mc.d, lu=mc.als_lu, lv=mc.als_lv, le=mc.als_le,
                   a=mc.als_a, b=mc.als_b, seed=mc.seed, device=device,
                   mesh=mesh)
    raise SystemExit(f"unknown model {mc.model!r}")


def _parse_mesh(spec: str, device):
    """A rank mesh from a CLI spec: "auto" (every rank, the square split of
    ``make_mesh``) or "DPxMP", e.g. 2x4 (cli.py:218-225). A spec that does
    not fit the process group exits 2."""
    from .parallel import make_mesh

    try:
        if spec == "auto":
            return make_mesh(device=device)
        dp, _, mp = spec.partition("x")
        return make_mesh(dp=int(dp), mp=int(mp), device=device)
    except ValueError as e:
        raise _fail(f"--mesh {spec}: {e}")


def _train_pairwise_distributed(model, mesh, cfg: TrainConfig) -> None:
    """The epoch loop of BPR and VBPR over a mesh through the distributed
    trainers (cli.py:228-263): tables row-sharded over "mp", each batch
    split over the ranks. Every rank draws the same chunks from the epoch's
    generator; at the end every rank holds the full tables."""
    from .models.bpr import stream_generator
    from .parallel import DistributedBPRTrainer, DistributedVBPRTrainer

    if cfg.warm_start is not None:
        tprint("Initialize weights with the previous trained model")
        model.import_embeddings(cfg.warm_start)
    limit = cfg.epoch_sample_limit or model.inter.nnz
    batch_limit = int(limit) // cfg.batch_size + 1
    scan_steps = min(64, batch_limit)
    n_chunks = max(1, -(-batch_limit // scan_steps))
    is_vbpr = type(model).__name__ == "VBPR"
    cls = DistributedVBPRTrainer if is_vbpr else DistributedBPRTrainer
    extra = {} if is_vbpr else {"exchange": cfg.exchange}
    trainer = cls(model, mesh, batch_size=cfg.batch_size,
                  scan_steps=scan_steps, **extra)
    for eid in range(cfg.epochs):
        t0 = time.time()
        gen = stream_generator(model.seed, eid, mesh.device)
        total = sum(trainer.train_chunk(gen) for _ in range(n_chunks))
        tprint("Epoch %3d, loss %.4f, time %.3fs (mesh %s)"
               % (eid + 1, total, time.time() - t0, mesh.shape))
    trainer.sync_to_model()


def train_from_config(cfg: TrainConfig, device="cuda", mesh=None):
    """Train the configured model on ``device``, export its files into
    ``cfg.out_dir`` (``final-*.dat``, and ``checkpoint.npz`` or
    ``final-E.dat`` where the model has them) and return the model
    (cli.py:266-361). DPM's encoder is ``cfg.encoder`` with the hidden
    widths ``cfg.encoder_hidden``.

    With a ``mesh`` the model lives on the mesh's device and trains over
    it. Every rank ends holding the full tables; rank 0 alone writes the
    files (and the logs, dumps and trace), and the other ranks wait for it
    at a barrier. The JAX CLI lets every process write the same paths."""
    from .checkpoint import OrbaxCheckpointError
    from .profiling import profile_trace

    mc = cfg.model
    if mc.model not in PORTED_MODELS:
        raise _fail(f"--model {mc.model} is not yet ported to topk_rec_torch "
                    f"(ported: {', '.join(PORTED_MODELS)})")
    if cfg.theta_init and mc.model != "wmf":
        # cer derives its item prior internally (F·E); a user theta would
        # be silently ignored
        raise SystemExit(
            f"--theta-init is only consumed by --model wmf "
            f"(got --model {mc.model})"
        )
    if cfg.exchange == "explicit" and mc.model != "bpr":
        raise SystemExit(
            "--exchange explicit is implemented for --model bpr "
            "(the other distributed paths ride GSPMD collectives)"
        )
    if cfg.exchange == "explicit" and mesh is None:
        raise SystemExit(
            "--exchange explicit requires --mesh (the all-to-all "
            "exchange runs over a device mesh)"
        )
    if cfg.exchange == "explicit" and mesh.shape["dp"] != 1:
        raise SystemExit(
            "--exchange explicit shards the batch over 'mp' and "
            f"requires a pure-mp mesh (dp=1); got mesh axes {mesh.shape}"
        )
    lead = mesh is None or mesh.rank == 0
    model = build_model(mc, _device(device) if mesh is None else mesh.device,
                        mesh)
    model.load_training_data(
        os.path.join(cfg.data.data_dir, cfg.data.uid_file),
        os.path.join(cfg.data.data_dir, cfg.data.iid_file),
        os.path.join(cfg.data.data_dir, cfg.data.train_file),
    )
    if mc.model in CONTENT_MODELS:
        if not cfg.data.content_file:
            raise SystemExit(f"--content is required for {mc.model}")
        model.load_content_data(
            os.path.join(cfg.data.data_dir, cfg.data.content_file),
            os.path.join(cfg.data.data_dir, cfg.data.iid_file),
        )
    save_dir = cfg.out_dir if cfg.save_lag and lead else None
    log_dir = cfg.log_dir if lead else None
    with profile_trace(cfg.profile_dir if lead else None):
        if mc.model in ("bpr", "vbpr") and mesh is not None:
            _train_pairwise_distributed(model, mesh, cfg)
        elif mc.model in ("bpr", "vbpr"):
            try:
                model.train(
                    epochs=cfg.epochs, batch_size=cfg.batch_size,
                    epoch_sample_limit=cfg.epoch_sample_limit,
                    model_path=cfg.warm_start, ckpt_dir=cfg.ckpt_dir,
                    ckpt_every=cfg.ckpt_every,
                )
            except OrbaxCheckpointError as e:
                raise _fail(str(e))
        elif mc.model == "dpm":
            from .models import MLPEncoder, SDAEEncoder

            enc_cls = {"mlp": MLPEncoder, "sdae": SDAEEncoder}.get(cfg.encoder)
            if enc_cls is None:
                raise SystemExit(f"unknown encoder {cfg.encoder!r}")
            enc = enc_cls(mc.k, model.d,
                          hidden_layers=tuple(cfg.encoder_hidden),
                          seed=mc.seed, device=model.device, mesh=mesh)
            model.train(enc, max_iter=cfg.max_iter, model_path=cfg.warm_start,
                        log_dir=log_dir, save_lag=cfg.save_lag,
                        save_dir=save_dir)
        else:
            extra = {}
            if mc.model == "wmf" and cfg.theta_init:
                # the cr solver's --theta_init: a raw [n_items, k] matrix
                # in item-index order (cli.py:344-352)
                extra["theta"] = read_dat(cfg.theta_init)
            model.train(
                max_iter=cfg.max_iter, tol=cfg.tol,
                model_path=cfg.warm_start, log_dir=log_dir,
                save_lag=cfg.save_lag, save_dir=save_dir, **extra,
            )
    if lead:
        model.export_embeddings(cfg.out_dir)
        tprint(f"Exported embeddings to {cfg.out_dir}")
    if mesh is not None:
        import torch.distributed as dist

        dist.barrier(group=mesh.group)
    return model


def cmd_train(args) -> int:
    cfg = TrainConfig(
        data=DataConfig(data_dir=args.data, fold=args.fold,
                        content_file=args.content),
        model=ModelConfig(
            model=args.model_name, k=args.k, d=args.d,
            lambda_u=args.lambda_u, lambda_i=args.lambda_i,
            lambda_j=args.lambda_j, lambda_b=args.lambda_b,
            lambda_e=args.lambda_e, lr=args.lr, mode=args.mode,
            als_lu=args.als_lu,
            als_lv=args.als_lv_wmf if args.model_name == "wmf" else args.als_lv,
            als_le=args.als_le, als_a=args.als_a, als_b=args.als_b,
            seed=args.seed, membership=args.membership,
        ),
        out_dir=args.out,
        epochs=args.epochs,
        batch_size=args.batch_size,
        epoch_sample_limit=args.epoch_sample_limit,
        max_iter=args.max_iter,
        tol=args.tol,
        warm_start=args.warm_start,
        encoder=args.encoder,
        encoder_hidden=list(args.encoder_hidden),
        log_dir=args.log_dir,
        profile_dir=args.profile_dir,
        save_lag=args.save_lag,
        theta_init=args.theta_init,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        exchange=args.exchange,
    )
    import torch.distributed as dist

    # a process group this command makes, it also ends: one left to the
    # interpreter's exit can hold the process there for minutes (NCCL)
    owned = not dist.is_initialized()
    try:
        if args.coordinator or os.environ.get("TKR_COORDINATOR"):
            # several processes: join the process group before any collective
            from .parallel import initialize

            initialize(args.coordinator, args.num_processes, args.process_id,
                       device=_device(args.device))
        mesh = (_parse_mesh(args.mesh, _device(args.device)) if args.mesh
                else None)
        train_from_config(cfg, args.device, mesh=mesh)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    return 0


def cmd_evaluate(args) -> int:
    # TKR_TIMING=1: the wall time of each phase on stderr (cli.py:136-181),
    # read from the phases' spans
    timing = os.environ.get("TKR_TIMING") == "1"
    with recording() if timing else contextlib.nullcontext() as rec:
        _evaluate(args)
    if timing:
        phases = [(name[len(EVALUATE):], t) for name, t in rec
                  if name.startswith(EVALUATE)]
        for name, t in phases:
            print(f"timing: {name} {t:.2f}s", file=sys.stderr)
        print(f"timing: total {sum(t for _, t in phases):.2f}s",
              file=sys.stderr)
    return 0


def _evaluate(args) -> None:
    """The phases of ``evaluate``, one span each: ``fold_parse``,
    ``dat_parse``, then ``<scenario>_inputs`` and ``<scenario>_eval`` per
    scenario."""
    from .eval.device import DeviceEvaluator

    with span(EVALUATE + "fold_parse"):
        device = _device(args.device)
        inter, uids, iids = _load_fold(args.data, args.fold)
    with span(EVALUATE + "dat_parse"):
        umat, vmat, bmat = _read_model(args.model, uids, iids)
    ev = None
    for scenario in args.scenarios:
        with span(f"{EVALUATE}{scenario}_inputs"):
            if ev is None:
                ev = DeviceEvaluator(
                    inter.seen_bitmap, step=args.step, total=args.total,
                    user_chunk=args.user_chunk,
                    use_kernel=args.engine == "kernel",
                    # the CSV prints accuracy only (ref evaluate.py:113-117)
                    want_rr=False, device=device,
                )
            cand_ids, likes = _scenario_inputs(
                args.data, args.fold, scenario, uids, iids
            )
        with span(f"{EVALUATE}{scenario}_eval"):
            res = ev.evaluate(umat, vmat, bmat, cand_ids, likes)
            # formatting reads the accuracies on the host: the card is done
            line = scenario + "".join(",%.6f" % a for a in res.accuracy)
        print(line)


FUSE_STRATEGIES = ("average", "rank", "error", "svm", "bpr")


def _fuse_weights(args, modalities, inter):
    """The strategy's weights: [F], or [n_users, F] for ``error``
    (cli.py:428-477)."""
    from .fusion import (
        average_weights,
        bpr_fusion_weights,
        error_weights,
        rank_geometric_weights,
        svm_fusion_weights,
    )

    F = modalities.n_feats
    if args.strategy == "average":
        return average_weights(F)
    if args.strategy == "rank":
        return rank_geometric_weights(F, args.p)
    if args.strategy == "error":
        return error_weights(modalities, inter, np.arange(inter.n_items))
    if args.strategy == "svm":
        return svm_fusion_weights(
            modalities, inter, seed=args.seed,
            n_samples=args.n_samples if args.n_samples is not None
            else 100_000)
    return bpr_fusion_weights(
        modalities, inter, seed=args.seed,
        n_samples=args.n_samples if args.n_samples is not None
        else 10_000_000)


def cmd_fuse(args) -> int:
    """Late fusion of several model directories: one
    ``strategy-scenario,acc...`` line per scenario, or with ``--p-sweep``
    nine ``rank-pX-scenario`` lines, p = 0.1 .. 0.9 (cli.py:408-491)."""
    from .eval.device import candidate_words
    from .fusion import ModalityScores, evaluate_fused, rank_geometric_weights

    device = _device(args.device)
    inter, uids, iids = _load_fold(args.data, args.fold)
    modalities = ModalityScores(
        [(_read_model_mat(m, "final-U.dat", uids),
          _read_model_mat(m, "final-V.dat", iids)) for m in args.models],
        device=device)
    scen = {}
    for scenario in args.scenarios:
        cand_ids, likes = _scenario_inputs(args.data, args.fold, scenario,
                                           uids, iids)
        # packed once per scenario, for every weighting evaluated on it
        scen[scenario] = (cand_ids, likes,
                          candidate_words(inter.seen_bitmap, cand_ids, device))

    def report(name, weights):
        for scenario, (cand_ids, likes, packed) in scen.items():
            res = evaluate_fused(modalities, weights, inter.seen_bitmap,
                                 cand_ids, likes, step=args.step,
                                 total=args.total, packed_seen=packed)
            print(f"{name}-{scenario}"
                  + "".join(",%.6f" % a for a in res.accuracy))

    if args.strategy == "rank" and args.p_sweep:
        # the reference's pfusion sweeps p over 0.1 .. 0.9 (pfusion.py:113)
        for p_val in [round(0.1 * i, 1) for i in range(1, 10)]:
            report(f"rank-p{p_val}",
                   rank_geometric_weights(modalities.n_feats, p_val))
        return 0
    report(args.strategy, _fuse_weights(args, modalities, inter))
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

    pt = sub.add_parser("train", help="train a model and export embeddings")
    pt.add_argument("--model", dest="model_name", required=True,
                    choices=MODELS,
                    help="bpr, vbpr, wmf, cer or dpm")
    pt.add_argument("-d", "--data", required=True)
    pt.add_argument("-o", "--out", required=True)
    pt.add_argument("-f", "--fold", type=int, default=0)
    pt.add_argument("--content", default=None,
                    help="content pickle filename (vbpr, cer, dpm)")
    pt.add_argument("--k", type=int, default=_MC.k)
    pt.add_argument("--d", type=int, default=_MC.d,
                    help="content feature width (vbpr, cer, dpm)")
    pt.add_argument("--epochs", type=int, default=_TC.epochs)
    pt.add_argument("--batch-size", type=int, default=_TC.batch_size)
    pt.add_argument("--epoch-sample-limit", type=int,
                    default=_TC.epoch_sample_limit)
    pt.add_argument("--max-iter", type=int, default=_TC.max_iter,
                    help="ALS iterations (wmf, cer, dpm)")
    pt.add_argument("--tol", type=float, default=_TC.tol,
                    help="ALS stop: relative loss change (wmf, cer)")
    pt.add_argument("--lr", type=float, default=_MC.lr)
    pt.add_argument("--mode", default=_MC.mode, choices=["l2", "l1"])
    pt.add_argument("--lambda-u", type=float, default=_MC.lambda_u)
    pt.add_argument("--lambda-i", type=float, default=_MC.lambda_i)
    pt.add_argument("--lambda-j", type=float, default=_MC.lambda_j)
    pt.add_argument("--lambda-b", type=float, default=_MC.lambda_b)
    pt.add_argument("--lambda-e", type=float, default=_MC.lambda_e)
    pt.add_argument("--als-lu", type=float, default=_MC.als_lu)
    pt.add_argument("--als-lv", type=float, default=_MC.als_lv)
    pt.add_argument("--als-lv-wmf", type=float, default=0.01,
                    help="WMF uses lv=0.01 (ref wmf.py:11) vs CER's 10")
    pt.add_argument("--als-le", type=float, default=_MC.als_le)
    pt.add_argument("--als-a", type=float, default=_MC.als_a)
    pt.add_argument("--als-b", type=float, default=_MC.als_b)
    pt.add_argument("--seed", type=int, default=_MC.seed)
    pt.add_argument("--membership", default=_MC.membership,
                    choices=["auto", "bitmap", "sorted"],
                    help="negative-sampling membership store (auto takes "
                    "the sorted keys when the bitmap would exceed 1 GiB)")
    pt.add_argument("--warm-start", default=_TC.warm_start)
    pt.add_argument("--log-dir", default=_TC.log_dir,
                    help="write state.log/settings.txt here (wmf, cer, "
                    "dpm)")
    pt.add_argument("--profile-dir", default=_TC.profile_dir,
                    help="write a torch.profiler trace of training here")
    pt.add_argument("--ckpt-dir", default=_TC.ckpt_dir,
                    help="crash-resume checkpoints (tables + optimizer "
                    "state) every --ckpt-every epochs; rerunning the same "
                    "command resumes")
    pt.add_argument("--ckpt-every", type=int, default=_TC.ckpt_every)
    pt.add_argument("--theta-init", default=_TC.theta_init,
                    help="item-prior .dat matrix ([n_items, k], item-index "
                    "order): inits V and enters every item solve as the "
                    "lv-weighted prior (reference cr --theta_init); wmf "
                    "only")
    pt.add_argument("--save-lag", type=int, default=_TC.save_lag,
                    help="dump %%04d-U/V.dat into -o every N ALS iterations "
                    "(reference cr --save_lag)")
    pt.add_argument("--encoder", default=_TC.encoder, choices=ENCODERS,
                    help="DPM content encoder (sdae: CDL-style, with "
                    "layer-wise denoising pretraining)")
    pt.add_argument("--encoder-hidden", type=int, nargs="+",
                    default=_TC.encoder_hidden,
                    help="DPM encoder hidden widths")
    pt.add_argument("--mesh", default=None,
                    help='rank mesh for distributed training: "auto" (every '
                    'rank) or "DPxMP" (e.g. 2x4); tables row-shard over mp, '
                    'batches split over the ranks')
    pt.add_argument("--exchange", default=_TC.exchange,
                    choices=["gspmd", "explicit"],
                    help="distributed BPR communication: gspmd (each batch "
                    "over every rank, no overflow) or the explicit "
                    "deduplicated all-to-all lookup/update exchange "
                    "(parameter-server pattern; requires a pure-mp mesh, "
                    "e.g. --mesh 1x8)")
    pt.add_argument("--coordinator", default=None,
                    help="several processes: the rendezvous host:port (or "
                    "an init URL such as file:///path)")
    pt.add_argument("--num-processes", type=int, default=None)
    pt.add_argument("--process-id", type=int, default=None)
    pt.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    pt.set_defaults(func=cmd_train)

    pf = sub.add_parser("fuse", help="late-fuse several model dirs")
    pf.add_argument("--strategy", required=True, choices=FUSE_STRATEGIES)
    pf.add_argument("-d", "--data", required=True)
    pf.add_argument("-m", "--models", nargs="+", required=True)
    pf.add_argument("-f", "--fold", type=int, default=0)
    pf.add_argument("-s", "--step", type=int, default=5)
    pf.add_argument("-t", "--total", type=int, default=30)
    pf.add_argument("-sl", "--scenarios", nargs="+", default=["im", "om"])
    pf.add_argument("--p", type=float, default=0.5, help="rank-fusion p")
    pf.add_argument("--p-sweep", action="store_true",
                    help="rank strategy: evaluate p in {0.1..0.9}, one CSV "
                    "line each (reference pfusion.py:113)")
    # None: svm 100k, bpr the reference's 10M (ranking_fusion.py:44)
    pf.add_argument("--n-samples", type=int, default=None)
    pf.add_argument("--seed", type=int, default=0)
    pf.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    pf.set_defaults(func=cmd_fuse)

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
