"""The port's BPR against the JAX package's: loss and gradients, one chunk
of steps on the same triplets, crash-resume, the ``.dat`` /
``checkpoint.npz`` interchange both ways, and trained accuracy.

Tolerances:
- loss and gradients: the same fp32 formula; XLA and torch sum the rows'
  products in different orders, so rtol 1e-5 / atol 1e-6;
- a chunk of steps: those differences pass through RMSProp's division by
  sqrt(acc), so after four steps the tables agree to rtol 1e-4 / atol 1e-6;
- the fused layout's chunk against JAX's own fused ``_chunk_impl``: rtol
  2e-5 / atol 1e-7 and the loss to rtol 1e-5, the tolerance of JAX's test
  of its two layouts (tests/test_models.py:366-374), at its size and step
  size (lr 1e-3); the port's two layouts run the same torch ops on the
  same rows and are held to the same tolerance;
- ``.dat`` files hold six decimals, so a table read back from one is within
  5e-7 (plus an fp32 ulp) of the trained table; ``checkpoint.npz`` is
  binary and exact;
- trained accuracy: JAX's threefry and the port's generators differ, so the
  two are held by seed statistics: the port's mean accuracy@30 over three
  seeds lies within three standard errors of the difference of the means
  (each package's seed variance over three seeds), plus 0.02 for the noise
  of a three-seed estimate, of JAX's, and at least 0.1 above the untrained
  tables'.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topk_rec_tpu.checkpoint import CheckpointManager as JaxCheckpoints
from topk_rec_tpu.data.dataset import Interactions, synthetic_interactions
from topk_rec_tpu.eval.protocol import evaluate_oracle
from topk_rec_tpu.models import BPR as JaxBPR
from topk_rec_tpu.models import bpr as jbpr
from topk_rec_tpu.models.bpr import _pairwise_loss as jax_loss
from topk_rec_tpu.ops import sampling as jsampling
from topk_rec_tpu.ops import sparse_update as jsu
from topk_rec_torch.checkpoint import CheckpointManager, OrbaxCheckpointError
from topk_rec_torch.data import Interactions as PortInteractions
from topk_rec_torch.interop import bpr_from_jax, bpr_to_jax
from topk_rec_torch.models import BPR, VBPR
from topk_rec_torch.models import bpr as tbpr
from topk_rec_torch.models import vbpr as tvbpr
from topk_rec_torch.models.bpr import (
    BPRTables,
    _pairwise_loss,
    fused_layout,
    run_chunk,
    run_chunk_fused,
)

DAT_TOL = dict(rtol=0, atol=6e-7)


def _port(inter):
    """The port's own Interactions over the same arrays as ``inter``."""
    return PortInteractions(inter.n_users, inter.n_items, inter.pos_u,
                            inter.pos_i, inter.seen_u, inter.seen_i)


@pytest.fixture(scope="module")
def fold():
    """tests/test_models.py:33-36: a synthetic fold with 20 % held out."""
    inter = synthetic_interactions(150, 100, 3000, seed=11)
    rng = np.random.default_rng(1)
    test = rng.random(inter.nnz) < 0.2
    tr = Interactions(inter.n_users, inter.n_items, inter.pos_u[~test],
                      inter.pos_i[~test])
    likes = {}
    for u, i in zip(inter.pos_u[test], inter.pos_i[test]):
        likes.setdefault(int(u), []).append(int(i))
    return tr, likes


def _rows(seed, n, k, scale=0.1):
    return (np.random.default_rng(seed).normal(size=(n, k)) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("mode", ["l2", "l1"])
@pytest.mark.parametrize("weighted", [False, True])
def test_pairwise_loss_and_grads_equal_jax(mode, weighted):
    k, b = 6, 32
    pu, pit, pjt = _rows(0, b, k), _rows(1, b, k + 1), _rows(2, b, k + 1)
    w = (np.random.default_rng(3).random(b) < 0.7).astype(np.float32)
    hyper = (2.5e-3, 2.5e-3, 2.5e-4, 0.01)
    weight = w if weighted else None
    jl, jg = jax.value_and_grad(
        lambda a, b_, c: jax_loss(a, b_, c, *hyper, mode, k,
                                  None if weight is None
                                  else jnp.asarray(weight)),
        argnums=(0, 1, 2))(jnp.asarray(pu), jnp.asarray(pit),
                           jnp.asarray(pjt))
    ts = [torch.from_numpy(a).requires_grad_() for a in (pu, pit, pjt)]
    tl = _pairwise_loss(*ts, *hyper, mode, k,
                        None if weight is None else torch.from_numpy(weight))
    tg = torch.autograd.grad(tl, ts)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    for g, want in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


def _jax_chunk(params, ms, u_steps, i_steps, j_steps, hyper, mode):
    """The JAX step of bpr.py:256-281, a Python loop over the steps:
    _pairwise_loss gradients, segment sums and apply_planned_rmsprop."""
    k = params["ue"].shape[1]
    b = u_steps.shape[1]
    uniq_u, seg_u = jsu.plan_sparse_updates(jnp.asarray(u_steps))
    uniq_ij, seg_ij = jsu.plan_sparse_updates(
        jnp.concatenate([jnp.asarray(i_steps), jnp.asarray(j_steps)], 1))
    ue, ms_u = jnp.asarray(params["ue"]), jnp.asarray(ms["ue"])
    iet = jnp.concatenate([jnp.asarray(params["ie"]),
                           jnp.asarray(params["ib"])[:, None]], 1)
    ms_it = jnp.concatenate([jnp.asarray(ms["ie"]),
                             jnp.asarray(ms["ib"])[:, None]], 1)
    h = (hyper["lu"], hyper["li"], hyper["lj"], hyper["lb"])
    total = 0.0
    for s in range(u_steps.shape[0]):
        rows_u, acc_u = jsu.planned_rows(ue, ms_u, uniq_u[s])
        rows_ij, acc_ij = jsu.planned_rows(iet, ms_it, uniq_ij[s])
        pu = rows_u[seg_u[s]]
        pit = rows_ij[seg_ij[s, :b]]
        pjt = rows_ij[seg_ij[s, b:]]
        loss, g = jax.value_and_grad(
            lambda a, b_, c: jax_loss(a, b_, c, *h, mode, k),
            argnums=(0, 1, 2))(pu, pit, pjt)
        agg_u = jax.ops.segment_sum(g[0], seg_u[s],
                                    num_segments=uniq_u.shape[1])
        agg_ij = jax.ops.segment_sum(jnp.concatenate([g[1], g[2]]),
                                     seg_ij[s], num_segments=uniq_ij.shape[1])
        ue, ms_u = jsu.apply_planned_rmsprop(ue, ms_u, uniq_u[s], rows_u,
                                             acc_u, agg_u, hyper["lr"])
        iet, ms_it = jsu.apply_planned_rmsprop(iet, ms_it, uniq_ij[s],
                                               rows_ij, acc_ij, agg_ij,
                                               hyper["lr"])
        total += float(loss)
    params = {"ue": ue, "ie": iet[:, :k], "ib": iet[:, k]}
    ms = {"ue": ms_u, "ie": ms_it[:, :k], "ib": ms_it[:, k]}
    return params, ms, total


@pytest.mark.parametrize("mode", ["l2", "l1"])
def test_one_chunk_equals_jax_step(small_inter, mode):
    """Four steps on identical tables, accumulators and triplets."""
    k, steps, batch = 6, 4, 64
    n_u, n_i = small_inter.n_users, small_inter.n_items
    params = {"ue": _rows(0, n_u, k), "ie": _rows(1, n_i, k),
              "ib": _rows(2, n_i, 1)[:, 0]}
    ms = {n: np.abs(v[::-1]) + 0.01 for n, v in params.items()}
    model = BPR(k=k, lambda_b=0.01, lr=0.05, mode=mode, device="cpu")
    model.set_interactions(_port(small_inter))
    u, i, j = model.sample_chunk(torch.Generator().manual_seed(4), steps,
                                 batch)
    hyper = model.hyper()

    want_p, want_ms, want_loss = _jax_chunk(params, ms, u.numpy(), i.numpy(),
                                            j.numpy(), hyper, mode)
    tables = BPRTables(*(torch.from_numpy(params[n]) for n in
                         ("ue", "ie", "ib")))
    tables.load(ms=ms)
    loss = run_chunk(tables, u, i, j, hyper, mode)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    for got, want in ((tables.params(), want_p), (tables.ms(), want_ms)):
        for name in ("ue", "ie", "ib"):
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), rtol=1e-4,
                                       atol=1e-6, err_msg=name)


FUSED_HYPER = dict(lambda_b=1e-4, lr=1e-3)  # tests/test_models.py:347-348


@pytest.fixture(scope="module")
def fused_inter():
    """tests/test_models.py:346: 120 users x 80 items, 2,000 pairs."""
    return synthetic_interactions(120, 80, 2000, seed=3)


def _fused_state(n_u, n_i, k):
    """Tables and non-zero accumulators, the item bias non-zero too."""
    params = {"ue": _rows(0, n_u, k), "ie": _rows(1, n_i, k),
              "ib": _rows(2, n_i, 1)[:, 0]}
    ms = {"ue": np.abs(_rows(3, n_u, k, 1e-4)),
          "ie": np.abs(_rows(4, n_i, k, 1e-4)),
          "ib": np.abs(_rows(5, n_i, 1, 1e-4))[:, 0]}
    return params, ms


def _tables(params, ms):
    """BPRTables holding copies of ``params`` and ``ms`` (a chunk updates
    them in place, and ``torch.from_numpy`` would alias the arrays)."""
    tables = BPRTables(*(torch.tensor(params[n]) for n in ("ue", "ie", "ib")))
    tables.load(ms=ms)
    return tables


def _watch_user_bias(monkeypatch, n_users, k):
    """Record, after every RMSProp update of a fused table, its user rows'
    bias column and that of the accumulator."""
    seen = []
    apply = tbpr.apply_planned_rmsprop

    def watched(table, acc, *args):
        out = apply(table, acc, *args)
        if table.shape[1] == k + 1 and table.shape[0] > n_users:
            seen.append(torch.cat([table[:n_users, k], acc[:n_users, k]]))
        return out

    monkeypatch.setattr(tbpr, "apply_planned_rmsprop", watched)
    return seen


@pytest.mark.parametrize("mode", ["l2", "l1"])
def test_fused_chunk_equals_jax_fused_chunk(fused_inter, monkeypatch, mode):
    """Four steps of JAX's own ``_chunk_impl(fused_tables=True)`` and the
    port's fused chunk on the same tables, accumulators and triplets."""
    k, steps, batch = 8, 4, 64
    n_u, n_i = fused_inter.n_users, fused_inter.n_items
    model = BPR(k=k, mode=mode, device="cpu", **FUSED_HYPER)
    model.set_interactions(_port(fused_inter))
    u, i, j = model.sample_chunk(torch.Generator().manual_seed(4), steps,
                                 batch)
    hyper = model.hyper()
    params, ms = _fused_state(n_u, n_i, k)

    def fixed_triplets(key, user_rows, flat_pos, pos_bitmap, n, n_items,
                       k_candidates):
        assert n == steps * batch and n_items == n_i
        return tuple(jnp.asarray(t.reshape(-1).numpy()) for t in (u, i, j))

    # _chunk_impl imports the sampler when it is called (bpr.py:134)
    monkeypatch.setattr(jsampling, "_sample_triplets", fixed_triplets)
    dummy = jnp.zeros(1, jnp.int32)
    want_p, want_ms, want_loss = jbpr._chunk_impl(
        {n: jnp.asarray(v) for n, v in params.items()},
        {n: jnp.asarray(v) for n, v in ms.items()},
        jax.random.PRNGKey(0), dummy, dummy, dummy, hyper, batch, n_i, 2,
        steps, mode, fused_tables=True)

    seen = _watch_user_bias(monkeypatch, n_u, k)
    tables = _tables(params, ms)
    loss = run_chunk_fused(tables, u, i, j, hyper, mode)
    assert len(seen) == steps and not any(c.any() for c in seen)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for got, want in ((tables.params(), want_p), (tables.ms(), want_ms)):
        for name in ("ue", "ie", "ib"):
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), rtol=2e-5,
                                       atol=1e-7, err_msg=name)


def test_fused_equals_separate(fused_inter, monkeypatch):
    """The port's two layouts on the same triplets, over two chunks; the
    fused table's user bias column and its accumulator stay exactly 0."""
    k, steps, batch = 8, 4, 64
    params, ms = _fused_state(fused_inter.n_users, fused_inter.n_items, k)
    model = BPR(k=k, device="cpu", **FUSED_HYPER)
    model.set_interactions(_port(fused_inter))
    gen = torch.Generator().manual_seed(5)
    chunks = [model.sample_chunk(gen, steps, batch) for _ in range(2)]
    seen = _watch_user_bias(monkeypatch, fused_inter.n_users, k)
    out = []
    for chunk in (run_chunk, run_chunk_fused):
        tables = _tables(params, ms)
        loss = sum(float(chunk(tables, *c, model.hyper(), "l2"))
                   for c in chunks)
        out.append((tables, loss))
    (sep, l_sep), (fus, l_fus) = out
    assert len(seen) == 2 * steps and not any(c.any() for c in seen)
    np.testing.assert_allclose(l_fus, l_sep, rtol=1e-5)
    for got, want in ((fus.params(), sep.params()), (fus.ms(), sep.ms())):
        for name in ("ue", "ie", "ib"):
            np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                       rtol=2e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("kind", ["bpr-separate", "bpr-fused", "vbpr"])
def test_chunk_reads_its_modules_loss_and_updates(small_inter, monkeypatch,
                                                  kind):
    """A chunk calls the loss and the updates that its model's module holds
    when it runs (the benchmark's faults patch them there): no-op updates
    leave every table and accumulator as it was, and the loss is called
    once a step."""
    steps, batch = 3, 32
    if kind == "vbpr":
        module, updates = tvbpr, ("apply_planned_rmsprop", "_rms_dense")
        model = VBPR(k=6, d=5, lr=0.05, device="cpu")
        model.set_interactions(_port(small_inter))
        model.set_features(_rows(7, small_inter.n_items, 5))
        chunk_args = ()
    else:
        module, updates = tbpr, ("apply_planned_rmsprop",)
        model = BPR(k=6, lr=0.05, device="cpu")
        model.set_interactions(_port(small_inter))
        chunk_args = (kind == "bpr-fused",)
    model._init_params(torch.Generator().manual_seed(0))
    before = {n: t.clone() for n, t in model.tables.state_dict().items()}
    name = "_vbpr_loss" if kind == "vbpr" else "_pairwise_loss"
    loss, calls = getattr(module, name), []

    def counted(*args, **kwargs):
        calls.append(1)
        return loss(*args, **kwargs)

    monkeypatch.setattr(module, name, counted)
    for update in updates:
        monkeypatch.setattr(module, update, lambda *args: None)
    model.train_chunk(torch.Generator().manual_seed(1), steps, batch,
                      *chunk_args)
    assert len(calls) == steps
    for n, t in model.tables.state_dict().items():
        assert torch.equal(t, before[n]), n


@pytest.mark.parametrize("layout", ["auto", "separate", "fused"])
@pytest.mark.parametrize("batch", [2047, 2048])
@pytest.mark.parametrize("n_rows", [262_144, 262_145])
def test_auto_layout_rule(layout, batch, n_rows):
    """The port's choice against JAX's expression (bpr.py:515-518) with
    JAX's own constants."""
    want = layout == "fused" or (
        layout == "auto" and batch >= jbpr._FUSED_LAYOUT_MIN_BATCH
        and n_rows <= jbpr._FUSED_LAYOUT_MAX_ROWS)
    assert fused_layout(layout, batch, n_rows) == want
    model = BPR(k=4, table_layout=layout, device="cpu")
    model.n_users, model.n_items = 1, n_rows - 1
    assert model.picks_fused(batch) == want


def _resume_equals_straight(inter, tmp_path, batch):
    """Four epochs straight against two epochs, then a resumed run to four:
    the same tables (per-epoch generators, accumulators restored)."""
    def make():
        m = BPR(k=6, lr=0.05, seed=11, device="cpu")
        m.set_interactions(_port(inter))
        return m

    straight = make()
    straight.train(epochs=4, batch_size=batch, scan_steps=4, verbose=False)
    d = str(tmp_path / "ckpt")
    make().train(epochs=2, batch_size=batch, scan_steps=4, verbose=False,
                 ckpt_dir=d)
    assert CheckpointManager(d).steps() == [1, 2]
    resumed = make()
    resumed.train(epochs=4, batch_size=batch, scan_steps=4, verbose=False,
                  ckpt_dir=d)
    for a, b in ((resumed.fue, straight.fue), (resumed.fie, straight.fie),
                 (resumed.fib, straight.fib)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(resumed.tables.ms_it.numpy(),
                                  straight.tables.ms_it.numpy())


def test_crash_resume_reproduces_uninterrupted_run(small_inter, tmp_path):
    _resume_equals_straight(small_inter, tmp_path, 64)


def _refuse(*args):
    raise AssertionError("the separate layout ran")


def test_crash_resume_fused_reproduces_uninterrupted_run(small_inter,
                                                         tmp_path,
                                                         monkeypatch):
    """The resume check at batch 2,048, where ``auto`` trains on the fused
    table: the separate chunk refuses to run."""
    model = BPR(k=6, device="cpu")
    model.set_interactions(_port(small_inter))
    assert model.picks_fused(2048)
    monkeypatch.setattr(tbpr, "run_chunk", _refuse)
    _resume_equals_straight(small_inter, tmp_path, 2048)


def test_checkpoint_manager_format_and_gc(tmp_path):
    """step_{N:08d}.npz with the JAX package's flat keys; keep/save_every
    GC; the JAX manager restores what the port saved."""
    tree = {"params": {"ue": torch.arange(8.0).reshape(4, 2),
                       "ib": np.arange(3, dtype=np.float32)},
            "ms": {"ue": torch.ones(4, 2)}}
    mgr = CheckpointManager(str(tmp_path), keep=2, save_every=5)
    assert not mgr.save(1, tree)
    for step in (5, 10, 15):
        assert mgr.save(step, tree)
    assert mgr.steps() == [10, 15]
    assert sorted(os.listdir(tmp_path)) == ["step_00000010.npz",
                                            "step_00000015.npz"]
    with np.load(tmp_path / "step_00000015.npz") as data:
        assert sorted(data.files) == ["ms/ue", "params/ib", "params/ue"]
    back = JaxCheckpoints(str(tmp_path)).restore(15)
    np.testing.assert_array_equal(back["params"]["ue"],
                                  np.arange(8.0).reshape(4, 2))
    mine = mgr.restore()
    np.testing.assert_array_equal(mine["params"]["ib"], np.arange(3))
    np.testing.assert_array_equal(mine["ms"]["ue"], np.ones((4, 2)))


def test_orbax_steps_are_refused(tmp_path):
    """The JAX manager writes step_{N:08d}/ orbax directories where orbax
    imports (as it does here), and the port cannot read them. The port's
    manager counts them as steps, refuses to restore one, or to name the
    newest step when that is one, with a message that names the JAX
    package and --ckpt-dir; its GC leaves them alone, and a newer npz step
    still resumes."""
    tree = {"params": {"ue": np.arange(8, dtype=np.float32).reshape(4, 2)}}
    jax_mgr = JaxCheckpoints(str(tmp_path))
    assert jax_mgr._orbax is not None
    for step in (1, 2):
        assert jax_mgr.save(step, tree)
    assert (tmp_path / "step_00000002").is_dir()
    mgr = CheckpointManager(str(tmp_path), keep=1)
    assert mgr.steps() == [1, 2]
    with pytest.raises(OrbaxCheckpointError, match="--ckpt-dir"):
        mgr.latest_step()
    with pytest.raises(OrbaxCheckpointError, match="topk_rec_tpu"):
        mgr.restore(1)
    for step in (3, 4):
        assert mgr.save(step, {"params": {"ue": torch.full((4, 2), step)}})
    assert mgr.steps() == [1, 2, 4]
    assert mgr.latest_step() == 4
    np.testing.assert_array_equal(mgr.restore()["params"]["ue"],
                                  np.full((4, 2), 4))
    assert (tmp_path / "step_00000001").is_dir()


def test_interchange_port_to_jax(fold, tmp_path):
    """The JAX BPR imports the port's final-*.dat and checkpoint.npz."""
    tr, _ = fold
    port = BPR(k=8, lr=0.05, seed=5, device="cpu")
    port.set_interactions(_port(tr))
    port.train(epochs=1, batch_size=128, verbose=False)
    port.export_embeddings(str(tmp_path))
    assert {"final-U.dat", "final-V.dat", "final-B.dat",
            "checkpoint.npz"} <= set(os.listdir(tmp_path))
    jm = JaxBPR(k=8)
    jm.set_interactions(tr)
    jm.import_embeddings(str(tmp_path))
    np.testing.assert_allclose(jm.fue, port.fue, **DAT_TOL)
    np.testing.assert_allclose(jm.fie, port.fie, **DAT_TOL)
    np.testing.assert_allclose(jm.fib, port.fib, **DAT_TOL)
    _, ms = bpr_to_jax(port)
    for name in ("ue", "ie", "ib"):
        np.testing.assert_array_equal(np.asarray(jm._ms[name]), ms[name])


def test_interchange_jax_to_port(fold, tmp_path):
    """The port imports the JAX BPR's files, and warm-starts from them."""
    tr, _ = fold
    jm = JaxBPR(k=8, lr=0.05, seed=5)
    jm.set_interactions(tr)
    jm.train(epochs=1, batch_size=128, verbose=False)
    jm.export_embeddings(str(tmp_path))
    port = BPR(k=8, device="cpu")
    port.set_interactions(_port(tr))
    port.import_embeddings(str(tmp_path))
    np.testing.assert_allclose(port.fue, jm.fue, **DAT_TOL)
    np.testing.assert_allclose(port.fib, jm.fib, **DAT_TOL)
    params, ms = bpr_to_jax(port)
    np.testing.assert_allclose(params["ie"], jm.fie, **DAT_TOL)
    for name in ("ue", "ie", "ib"):
        np.testing.assert_array_equal(ms[name], np.asarray(jm._ms[name]))
    warm = BPR(k=8, lr=0.05, seed=6, device="cpu")
    warm.set_interactions(_port(tr))
    warm.train(epochs=0, batch_size=128, model_path=str(tmp_path),
               verbose=False)
    np.testing.assert_allclose(warm.fue, jm.fue, **DAT_TOL)
    np.testing.assert_allclose(warm.fib.reshape(-1), jm.fib.reshape(-1),
                               **DAT_TOL)


def test_interop_state_roundtrip(small_inter):
    """bpr_from_jax then bpr_to_jax returns the JAX state unchanged."""
    k = 5
    n_u, n_i = small_inter.n_users, small_inter.n_items
    params = {"ue": _rows(0, n_u, k), "ie": _rows(1, n_i, k),
              "ib": _rows(2, n_i, 1)[:, 0]}
    ms = {n: np.abs(v) * 0.5 for n, v in params.items()}
    model = BPR(k=k, device="cpu")
    model.set_interactions(_port(small_inter))
    bpr_from_jax(model, params, ms)
    got_p, got_ms = bpr_to_jax(model)
    for want, got in ((params, got_p), (ms, got_ms)):
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(model.fib.reshape(-1), params["ib"])


def test_validation():
    assert BPR(k=4, table_layout="fused", device="cpu").table_layout == \
        "fused"
    with pytest.raises(ValueError, match="table_layout"):
        BPR(k=4, table_layout="dense", device="cpu")
    with pytest.raises(ValueError, match="membership"):
        BPR(k=4, membership="dense", device="cpu")
    with pytest.raises(ValueError, match="mode"):
        BPR(k=4, mode="l3", device="cpu")
    with pytest.raises(ValueError, match="no training data"):
        BPR(k=4, device="cpu").train(epochs=1)


def _acc30(model, tr, likes):
    scores = model.scores(np.arange(tr.n_items))
    seen = tr.dense_matrix() > 0
    return evaluate_oracle(scores, seen, likes, step=5, total=30).accuracy[-1]


def test_trained_accuracy_within_seed_variance_of_jax(fold):
    tr, likes = fold
    got = {"port": [], "jax": [], "base": []}
    for seed in (3, 4, 5):
        port = BPR(k=16, lr=0.05, seed=seed, device="cpu")
        port.set_interactions(_port(tr))
        port.train(epochs=4, batch_size=256, verbose=False)
        got["port"].append(_acc30(port, tr, likes))
        jm = JaxBPR(k=16, lr=0.05, seed=seed)
        jm.set_interactions(tr)
        jm.train(epochs=4, batch_size=256, verbose=False)
        got["jax"].append(_acc30(jm, tr, likes))
        base = BPR(k=16, seed=seed, device="cpu")
        base.set_interactions(_port(tr))
        base.train(epochs=0, verbose=False)
        got["base"].append(_acc30(base, tr, likes))
    port, jx, base = (np.array(got[n]) for n in ("port", "jax", "base"))
    se = np.sqrt(port.var(ddof=1) / 3 + jx.var(ddof=1) / 3)
    assert abs(port.mean() - jx.mean()) <= 3 * se + 0.02, got
    assert port.mean() >= base.mean() + 0.1, got
