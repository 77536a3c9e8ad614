"""Rank bodies of the port's multi-rank CPU tests.

The tests of ``topk_rec_torch.parallel`` hold the port, run in 2 or 4
``torch.distributed`` ranks on gloo, against the JAX package, run in the
pytest process on its virtual CPU devices. :func:`spawn` starts the ranks
from ``torch.multiprocessing``'s spawn context, each joining the group
through a ``file://`` rendezvous under the test's ``tmp_path`` (so that
concurrent pytest workers never compete for a port), runs one body per
rank and returns what each rank returned. Every rank is joined with a
deadline: a rank that hangs fails its test instead of holding the suite.

This module is what the spawned ranks import: it imports neither jax nor
the JAX package. Every body takes its inputs as NumPy arrays, which the
test draws from a seed, and returns NumPy arrays.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

DEADLINE_S = 150.0


def _entry(fn, rank, world, init_file, out_dir, args):
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            result = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn, world: int, tmp_path, *args, deadline_s: float = DEADLINE_S):
    """Run ``fn(rank, *args)`` on ``world`` gloo ranks; returns the list of
    their results in rank order. Fails (after killing every rank) when a
    rank raised or had not ended ``deadline_s`` after the start."""
    out_dir = tmp_path / f"{fn.__name__}_{world}"
    out_dir.mkdir()
    ctx = tmp.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, str(out_dir / "rendezvous"),
                               str(out_dir), args))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    for p in procs:
        p.join(max(0.0, end - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [(out_dir / f"rank{r}.err").read_text()
              for r in range(world) if (out_dir / f"rank{r}.err").exists()]
    assert not errors, "\n".join(errors)
    assert not hung, f"ranks {hung} still running after {deadline_s} s"
    assert [p.exitcode for p in procs] == [0] * world
    results = []
    for r in range(world):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _np(t):
    return t.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
# lookup.py
# ---------------------------------------------------------------------------


def lookup_body(rank, cases_by_mesh):
    """For each (dp, mp) of ``cases_by_mesh`` and each of its cases, this
    rank's ``sharded_lookup`` rows and overflow, ``sharded_update`` block
    and overflow, ``_exchange(with_valid=True)`` rows, mask and overflow,
    and (pure-mp meshes) ``_exchange_rmsprop`` blocks and overflow."""
    from topk_rec_torch.parallel import make_mesh
    from topk_rec_torch.parallel.lookup import (
        _exchange,
        _exchange_rmsprop,
        sharded_lookup,
        sharded_update,
    )

    out = {}
    for (dp, mp), cases in cases_by_mesh.items():
        mesh = make_mesh(dp=dp, mp=mp, device="cpu")
        m = mesh.coords["mp"]
        for name, c in cases.items():
            table, idx, cap = c["table"], c["idx"], c["capacity"]
            per = table.shape[0] // mp
            block = torch.from_numpy(table[m * per:(m + 1) * per].copy())
            res = {}
            if c.get("lookup", True):
                rows, ovf = sharded_lookup(block, idx, mesh, capacity=cap)
                res["rows"], res["ovf"] = _np(rows), _np(ovf)
            if "rows" in c:
                new, ovf = sharded_update(block.clone(), idx, c["rows"], mesh,
                                          capacity=cap)
                res["update"], res["update_ovf"] = _np(new), _np(ovf)
            bl = idx.shape[0] // mp
            mine = torch.from_numpy(idx[m * bl:(m + 1) * bl])
            if cap:
                rows, valid, ovf = _exchange(block, mine, mesh, "mp", per,
                                             cap, with_valid=True)
                res["x_rows"], res["x_valid"], res["x_ovf"] = (
                    _np(rows), _np(valid), _np(ovf))
            if "grads" in c and dp == 1:
                acc = torch.from_numpy(c["acc"][m * per:(m + 1) * per].copy())
                g = torch.from_numpy(c["grads"][m * bl:(m + 1) * bl])
                tab, acc, ovf = _exchange_rmsprop(block.clone(), acc, mine, g,
                                                  mesh, "mp", per, cap,
                                                  c["lr"])
                res["rms_table"], res["rms_acc"], res["rms_ovf"] = (
                    _np(tab), _np(acc), _np(ovf))
            out[(dp, mp, name)] = res
    return out


# ---------------------------------------------------------------------------
# train_step.py: the BPR and VBPR trainers
# ---------------------------------------------------------------------------


def _bpr_model(inter_arrays, k, lr, device="cpu"):
    from topk_rec_torch.data import Interactions
    from topk_rec_torch.models import BPR

    model = BPR(k=k, lr=lr, lambda_b=0.01, device=device)
    model.set_interactions(Interactions(*inter_arrays))
    return model


def trainers_body(rank, inter_arrays, feat, bpr_cases, vbpr_case, auto_mesh,
                  jax_state):
    """Each BPR case ({"mesh", "exchange", "capacity", "params", "ms",
    "u", "i", "j"}) and the VBPR case run one chunk from the given state on
    the given triplets; returns each case's loss, last_overflow and full
    (params, ms) as every rank holds them, and the exchange that "auto"
    picks on ``auto_mesh``. ``jax_state`` (a JAX trainer's fetched params
    and ms) goes through ``interop.distributed_from_jax`` onto a 2x2 mesh
    and back through ``distributed_to_jax``; this rank's shards come back
    too."""
    from topk_rec_torch.data import Interactions
    from topk_rec_torch.models import VBPR
    from topk_rec_torch.parallel import (
        DistributedBPRTrainer,
        DistributedVBPRTrainer,
        make_mesh,
    )

    meshes = {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_mesh(dp=shape[0], mp=shape[1], device="cpu")
        return meshes[shape]

    def state(tr):
        p, m = tr.state()
        return ({n: _np(t) for n, t in p.items()},
                {n: _np(t) for n, t in m.items()})

    out = {}
    for name, c in bpr_cases.items():
        model = _bpr_model(inter_arrays, c["k"], c["lr"])
        tr = DistributedBPRTrainer(model, mesh_of(c["mesh"]),
                                   batch_size=c["u"].shape[1],
                                   scan_steps=c["u"].shape[0],
                                   exchange=c["exchange"],
                                   capacity=c["capacity"])
        tr.load(c["params"], c["ms"])
        loss = tr.run_chunk(*(torch.from_numpy(c[n]) for n in "uij"))
        out[name] = (loss, tr.last_overflow, state(tr))
    c = vbpr_case
    model = VBPR(k=c["k"], d=feat.shape[1], lr=c["lr"], lambda_b=0.01,
                 lambda_e=0.02, device="cpu")
    model.set_interactions(Interactions(*inter_arrays))
    model.set_features(feat)
    tr = DistributedVBPRTrainer(model, mesh_of(c["mesh"]),
                                batch_size=c["u"].shape[1],
                                scan_steps=c["u"].shape[0])
    tr.load(c["params"], c["ms"])
    loss = tr.run_chunk(*(torch.from_numpy(c[n]) for n in "uij"))
    out["vbpr"] = (loss, 0, state(tr))
    model = _bpr_model(inter_arrays, 4, 0.05)
    out["auto"] = DistributedBPRTrainer(model, mesh_of(auto_mesh),
                                        batch_size=16, scan_steps=1,
                                        exchange="auto").exchange
    from topk_rec_torch.interop import distributed_from_jax, distributed_to_jax

    model = _bpr_model(inter_arrays, jax_state[0]["ue"].shape[1], 0.05)
    tr = DistributedBPRTrainer(model, mesh_of((2, 2)), batch_size=16)
    distributed_from_jax(tr, *jax_state)
    out["interop"] = (distributed_to_jax(tr),
                      {n: _np(t) for n, t in tr.tables.params().items()})
    return out


# ---------------------------------------------------------------------------
# als.py, WMF / CER with a mesh, the data-parallel encoder fit
# ---------------------------------------------------------------------------


def als_body(rank, shape, inter_arrays, sweeps, feat, enc):
    """The ``DistributedALS`` half-sweeps of ``sweeps`` (each {"side",
    "this", "other", "lam", "prior", "block"}), WMF (3 iterations) and CER
    (2) trained with the mesh, DPM (2) trained with the mesh and without
    one, and one data-parallel encoder fit sweep from ``enc``'s weights;
    every result as this rank holds it."""
    from topk_rec_torch.data import Interactions
    from topk_rec_torch.models import CER, DPM, WMF, MLPEncoder
    from topk_rec_torch.ops.als import ALSPlan
    from topk_rec_torch.parallel import DistributedALS, make_mesh

    mesh = make_mesh(dp=shape[0], mp=shape[1], device="cpu")
    inter = Interactions(*inter_arrays)
    out = {}
    dals = DistributedALS(mesh)
    for name, s in sweeps.items():
        indptr, flat = inter.user_csr if s["side"] == "user" \
            else inter.item_csr
        n_this = inter.n_users if s["side"] == "user" else inter.n_items
        rated = inter.rated_items if s["side"] == "user" \
            else inter.rated_users
        plan = ALSPlan(indptr, flat, n_this, block_size=s["block"],
                       device="cpu")
        new, fit = dals.half_sweep(plan, s["this"], s["other"], rated, 1.0,
                                   0.01, s["lam"], prior=s["prior"])
        out[name] = (new, fit)
    wmf = WMF(k=6, seed=3, mesh=mesh)
    wmf.set_interactions(inter)
    wmf.train(max_iter=3, verbose=False)
    out["wmf"] = (wmf.fue, wmf.fie)
    cer = CER(k=6, d=feat.shape[1], seed=3, mesh=mesh)
    cer.set_interactions(inter)
    cer.set_features(feat)
    cer.train(max_iter=2, verbose=False)
    out["cer"] = (cer.fue, cer.fie, cer.E)
    dpm = {}
    for name, where in (("mesh", {"mesh": mesh}), ("local", {"device": "cpu"})):
        model = DPM(k=6, d=feat.shape[1], lu=1.0, seed=3, block_size=64,
                    **where)
        model.set_interactions(inter)
        model.set_features(feat)
        model.train(MLPEncoder, max_iter=2, verbose=False)
        dpm[name] = (model.fue, model.fie, model.encoder.mesh is mesh)
    out["dpm"] = dpm
    encoder = MLPEncoder(enc["k"], enc["X"].shape[1], lr=enc["lr"],
                         hidden_layers=enc["hidden"], seed=enc["seed"],
                         batch_size=enc["batch"], mesh=mesh)
    encoder.load_state_dict(enc["state"])
    loss = encoder.fit(enc["X"], enc["Y"])
    out["encoder"] = (loss, encoder.state_dict())
    return out


# ---------------------------------------------------------------------------
# serving.py with a mesh, distributed_scores_topk
# ---------------------------------------------------------------------------


def serving_body(rank, shape, inter_arrays, U, V, b, users, forced, k):
    """``TopKServer(mesh=)`` with ``exact`` on both seen stores; the
    capacities ``recommend`` tried on ``forced`` (a batch served from a
    sticky capacity of 1); ``distributed_scores_topk`` of (U, V, b)."""
    from topk_rec_torch.data import Interactions
    from topk_rec_torch.parallel import make_mesh
    from topk_rec_torch.parallel.train_step import distributed_scores_topk
    from topk_rec_torch.serving import TopKServer

    mesh = make_mesh(dp=shape[0], mp=shape[1], device="cpu")
    inter = Interactions(*inter_arrays)
    out = {}
    for fmt in ("bitmap", "lists"):
        srv = TopKServer(U, V, b, inter, mesh=mesh, seen_format=fmt)
        out[fmt] = srv.recommend(users, k=k, method="exact")
        tried = []
        ask = srv.recommend_async

        def logged(*a, **kw):
            tried.append(srv._lookup_capacity)
            return ask(*a, **kw)

        srv.recommend_async = logged
        srv._lookup_capacity = 1
        got = srv.recommend(forced, k=k, method="exact")
        out[fmt + "_forced"] = (got, tried, srv._lookup_capacity)
    out["scores"] = distributed_scores_topk(mesh, U, V, b, k)
    return out
