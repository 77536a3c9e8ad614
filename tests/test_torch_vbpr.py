"""The port's VBPR against the JAX package's: one chunk of steps on the same
tables and triplets, the init and its warm-start splits, the state
converters, crash-resume, the ``.dat`` / ``checkpoint.npz`` interchange
both ways, and trained accuracy.

Tolerances:
- a chunk of steps: JAX's own ``_chunk_impl`` runs unchanged on the port's
  triplets (its sampler is replaced in this test only). The same fp32
  formula summed in different orders passes through RMSProp's division by
  sqrt(acc), so after four steps the tables agree to rtol 1e-4 / atol 1e-6,
  as the BPR chunk (``tests/test_torch_bpr.py``); the summed loss to rtol
  1e-5;
- a warm start copies the tables: equal;
- ``.dat`` files hold six decimals and ``checkpoint.npz`` is exact, so the
  composed export tables read back through the other package agree within
  3e-6, the tolerance of ``tests/test_models.py:294``;
- trained accuracy: the random streams differ (threefry against torch
  generators), so the two are held by seed statistics as BPR's: the port's
  mean accuracy@30 over three seeds lies within three standard errors of
  the difference of the means, plus 0.02, of JAX's, and at least 0.1 above
  the untrained tables'.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import topk_rec_tpu.models.vbpr as jvbpr
from topk_rec_tpu.data.dataset import (
    Interactions,
    synthetic_features,
    synthetic_interactions,
)
from topk_rec_tpu.eval.protocol import evaluate_oracle
from topk_rec_torch.checkpoint import CheckpointManager
from topk_rec_torch.data import Interactions as PortInteractions
from topk_rec_torch.interop import vbpr_from_jax, vbpr_to_jax
from topk_rec_torch.models import VBPR
from topk_rec_torch.models.bpr import INIT_STREAM, stream_generator
from topk_rec_torch.models.vbpr import NAMES, VBPRTables, run_chunk

CHUNK_TOL = dict(rtol=1e-4, atol=1e-6)
DAT_TOL = dict(rtol=0, atol=3e-6)


@pytest.fixture(scope="module")
def content_fold():
    """tests/test_models.py:33-36, 171-175: a synthetic fold with 20 % of the
    positives held out and 40 features that predict the items."""
    inter = synthetic_interactions(150, 100, 3000, seed=11)
    rng = np.random.default_rng(1)
    test = rng.random(inter.nnz) < 0.2
    tr = Interactions(inter.n_users, inter.n_items, inter.pos_u[~test],
                      inter.pos_i[~test])
    tr._cache["i_lat"] = inter._cache["i_lat"]
    likes = {}
    for u, i in zip(inter.pos_u[test], inter.pos_i[test]):
        likes.setdefault(int(u), []).append(int(i))
    return tr, likes, synthetic_features(tr, d=40, seed=2)


def _rows(seed, *shape, scale=0.1):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _state(n_u, n_i, d, kh):
    params = {"ure": _rows(0, n_u, kh), "uce": _rows(1, n_u, kh),
              "ire": _rows(2, n_i, kh), "irb": _rows(3, n_i),
              "cem": _rows(4, d, kh, scale=0.01), "icb": _rows(5, d,
                                                               scale=0.01)}
    ms = {n: np.abs(_rows(10 + j, *v.shape)) + 0.01
          for j, (n, v) in enumerate(params.items())}
    return params, ms


def _port(inter):
    """The port's own Interactions over the same arrays as ``inter``."""
    return PortInteractions(inter.n_users, inter.n_items, inter.pos_u,
                            inter.pos_i, inter.seen_u, inter.seen_i)


def _model(inter, feat, **kw):
    m = VBPR(d=feat.shape[1], device="cpu", **kw)
    m.set_interactions(_port(inter))
    m.set_features(feat)
    return m


@pytest.mark.parametrize("full_k", [False, True])
@pytest.mark.parametrize("mode", ["l2", "l1"])
def test_one_chunk_equals_jax_chunk(small_inter, monkeypatch, mode, full_k):
    """Four steps of JAX's real ``_chunk_impl`` and the port's
    ``run_chunk`` on identical tables, accumulators, features and triplets,
    with every regularizer on (lambda_b and lambda_e included)."""
    k, d, steps, batch = 6, 10, 4, 64
    kh = k if full_k else k // 2
    n_u, n_i = small_inter.n_users, small_inter.n_items
    feat = _rows(20, n_i, d, scale=1.0)
    model = _model(small_inter, feat, k=k, lambda_b=0.01, lambda_e=0.02,
                   lr=0.05, mode=mode, full_k=full_k)
    u, i, j = model.sample_chunk(torch.Generator().manual_seed(4), steps,
                                 batch)
    hyper = model.hyper()
    params, ms = _state(n_u, n_i, d, kh)

    def fixed_triplets(key, user_rows, flat_pos, pos_bitmap, n, n_items,
                       k_candidates):
        assert n == steps * batch and n_items == n_i
        return tuple(jnp.asarray(t.reshape(-1).numpy()) for t in (u, i, j))

    monkeypatch.setattr(jvbpr, "_sample_triplets", fixed_triplets)
    dummy = jnp.zeros(1, jnp.int32)
    want_p, want_ms, want_loss = jvbpr._chunk_impl(
        {n: jnp.asarray(v) for n, v in params.items()},
        {n: jnp.asarray(v) for n, v in ms.items()},
        jax.random.PRNGKey(0), jnp.asarray(feat), dummy, dummy, dummy,
        hyper, batch, n_i, 2, steps, mode)

    tables = VBPRTables({n: torch.from_numpy(v) for n, v in params.items()})
    tables.load(ms=ms)
    loss = run_chunk(tables, torch.from_numpy(feat), u, i, j, hyper, mode)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    for got, want in ((tables.params(), want_p), (tables.ms(), want_ms)):
        for name in NAMES:
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), **CHUNK_TOL,
                                       err_msg=name)


@pytest.mark.parametrize("full_k", [False, True])
def test_init_and_warm_start_splits_equal_jax(small_inter, full_k):
    """Fresh init: N(0, 0.01) tables of half (or, full_k, whole) width, zero
    biases, cem the constant 2/(d·k). Warm start: fue's halves become
    ure/uce, fie[:, :kh] ire and fib irb, as JAX's ``_init_params``."""
    k, d = 6, 10
    kh = k if full_k else k // 2
    feat = _rows(21, small_inter.n_items, d, scale=1.0)
    port = _model(small_inter, feat, k=k, full_k=full_k)
    port._init_params(stream_generator(0, INIT_STREAM, "cpu"))
    p = port.tables.params()
    assert p["ure"].shape == (small_inter.n_users, kh)
    assert p["cem"].shape == (d, kh)
    np.testing.assert_array_equal(p["cem"].numpy(),
                                  np.full((d, kh), 2.0 / (d * k), np.float32))
    assert not p["irb"].any() and not p["icb"].any()
    assert 0.008 < float(p["ure"].std()) < 0.012
    for t in port.tables.ms().values():
        assert not t.any()

    jm = jvbpr.VBPR(k=k, d=d, full_k=full_k)
    jm.set_interactions(small_inter)
    jm.set_features(feat)
    fue = _rows(22, small_inter.n_users, 2 * kh)
    fie = _rows(23, small_inter.n_items, 2 * kh)
    fib = _rows(24, small_inter.n_items, 1)
    for m in (jm, port):
        m.fue, m.fie, m.fib = fue, fie, fib
    jm._init_params(jax.random.PRNGKey(0))
    port._init_params(stream_generator(0, INIT_STREAM, "cpu"))
    got = port.tables.params()
    for name in NAMES:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(jm._params[name]),
                                      err_msg=name)


def test_interop_state_roundtrip(content_fold):
    """vbpr_from_jax then vbpr_to_jax returns the JAX state unchanged, and
    the model's export tables follow the loaded state."""
    tr, _, feat = content_fold
    params, ms = _state(tr.n_users, tr.n_items, feat.shape[1], 4)
    model = _model(tr, feat, k=8)
    vbpr_from_jax(model, params, ms)
    got_p, got_ms = vbpr_to_jax(model)
    for want, got in ((params, got_p), (ms, got_ms)):
        assert sorted(got) == sorted(NAMES)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(model.fue[:, 4:], params["uce"])
    np.testing.assert_allclose(model.fie[:, 4:], feat @ params["cem"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(model.fib[:, 0],
                               params["irb"] + feat @ params["icb"],
                               rtol=1e-5, atol=1e-6)


def test_crash_resume_reproduces_uninterrupted_run(small_inter, tmp_path):
    """Four epochs straight against two epochs, then a resumed run to four:
    the same tables and accumulators (per-epoch generators from (seed,
    epoch), cem/icb and every accumulator restored)."""
    feat = _rows(25, small_inter.n_items, 8, scale=1.0)

    def make():
        return _model(small_inter, feat, k=6, lr=0.05, seed=11)

    straight = make()
    straight.train(epochs=4, batch_size=64, scan_steps=4, verbose=False)
    d = str(tmp_path / "ckpt")
    make().train(epochs=2, batch_size=64, scan_steps=4, verbose=False,
                 ckpt_dir=d)
    assert CheckpointManager(d).steps() == [1, 2]
    with np.load(os.path.join(d, "step_00000002.npz")) as data:
        assert sorted(data.files) == sorted(
            [f"params/{n}" for n in NAMES] + [f"ms/{n}" for n in NAMES])
    resumed = make()
    resumed.train(epochs=4, batch_size=64, scan_steps=4, verbose=False,
                  ckpt_dir=d)
    for a, b in ((resumed.fue, straight.fue), (resumed.fie, straight.fie),
                 (resumed.fib, straight.fib)):
        np.testing.assert_array_equal(a, b)
    for name, t in resumed.tables.named_buffers():
        np.testing.assert_array_equal(
            t.numpy(), dict(straight.tables.named_buffers())[name].numpy())


def _native_keys():
    return sorted(["cem", "icb", "irb"] + [f"ms_{n}" for n in NAMES])


def test_interchange_port_to_jax(content_fold, tmp_path):
    """The JAX VBPR imports the port's final-*.dat and checkpoint.npz and
    composes the same export tables."""
    tr, _, feat = content_fold
    port = _model(tr, feat, k=8, lr=0.05, seed=16)
    port.train(epochs=1, batch_size=128, verbose=False)
    port.export_embeddings(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == [
        "checkpoint.npz", "final-B.dat", "final-U.dat", "final-V.dat"]
    with np.load(tmp_path / "checkpoint.npz") as data:
        assert sorted(data.files) == _native_keys()
    jm = jvbpr.VBPR(k=8, d=feat.shape[1], seed=17)
    jm.set_interactions(tr)
    jm.set_features(feat)
    jm.import_embeddings(str(tmp_path))
    jm.train(epochs=0, batch_size=128, verbose=False)
    params, ms = vbpr_to_jax(port)
    for name in ("cem", "icb", "irb"):
        np.testing.assert_array_equal(np.asarray(jm._params[name]),
                                      params[name])
    for name in NAMES:
        np.testing.assert_array_equal(np.asarray(jm._ms[name]), ms[name])
    for got, want in ((jm.fue, port.fue), (jm.fie, port.fie),
                      (jm.fib, port.fib)):
        np.testing.assert_allclose(got, want, **DAT_TOL)


def test_interchange_jax_to_port(content_fold, tmp_path):
    """The port imports the JAX VBPR's files: the same composed tables,
    cem/icb/irb and accumulators exact, and a warm start from them."""
    tr, _, feat = content_fold
    jm = jvbpr.VBPR(k=8, d=feat.shape[1], lr=0.05, seed=16)
    jm.set_interactions(tr)
    jm.set_features(feat)
    jm.train(epochs=1, batch_size=128, verbose=False)
    jm.export_embeddings(str(tmp_path))
    port = _model(tr, feat, k=8, seed=17)
    port.import_embeddings(str(tmp_path))
    port.train(epochs=0, batch_size=128, verbose=False)
    params, ms = vbpr_to_jax(port)
    for name in ("cem", "icb", "irb"):
        np.testing.assert_array_equal(params[name],
                                      np.asarray(jm._params[name]))
    for name in NAMES:
        np.testing.assert_array_equal(ms[name], np.asarray(jm._ms[name]))
    for got, want in ((port.fue, jm.fue), (port.fie, jm.fie),
                      (port.fib, jm.fib)):
        np.testing.assert_allclose(got, want, **DAT_TOL)
    assert port._feat_dev is None  # F is released after train


def test_validation(content_fold):
    tr, _, feat = content_fold
    with pytest.raises(ValueError, match="mode"):
        VBPR(k=4, d=4, mode="l3", device="cpu")
    with pytest.raises(ValueError, match="membership"):
        VBPR(k=4, d=4, membership="dense", device="cpu")
    m = VBPR(k=4, d=4, device="cpu")
    m.set_interactions(_port(tr))
    with pytest.raises(ValueError, match="features"):
        m.train(epochs=1)


def _acc30(model, tr, likes):
    scores = model.scores(np.arange(tr.n_items))
    seen = tr.dense_matrix() > 0
    return evaluate_oracle(scores, seen, likes, step=5, total=30).accuracy[-1]


def test_trained_accuracy_within_seed_variance_of_jax(content_fold):
    tr, likes, feat = content_fold
    got = {"port": [], "jax": [], "base": []}
    for seed in (3, 4, 5):
        port = _model(tr, feat, k=16, lr=0.05, seed=seed)
        port.train(epochs=4, batch_size=256, verbose=False)
        got["port"].append(_acc30(port, tr, likes))
        jm = jvbpr.VBPR(k=16, d=feat.shape[1], lr=0.05, seed=seed)
        jm.set_interactions(tr)
        jm.set_features(feat)
        jm.train(epochs=4, batch_size=256, verbose=False)
        got["jax"].append(_acc30(jm, tr, likes))
        base = _model(tr, feat, k=16, seed=seed)
        base.train(epochs=0, verbose=False)
        got["base"].append(_acc30(base, tr, likes))
    port, jx, base = (np.array(got[n]) for n in ("port", "jax", "base"))
    se = np.sqrt(port.var(ddof=1) / 3 + jx.var(ddof=1) / 3)
    assert abs(port.mean() - jx.mean()) <= 3 * se + 0.02, got
    assert port.mean() >= base.mean() + 0.1, got
