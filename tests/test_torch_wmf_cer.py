"""The port's WMF and CER against the JAX package's: whole training runs
from the same NumPy init, the ridge E-solves on both routes, the theta
prior, the ``save_lag`` dumps, ``state.log``, the cold-start write-back and
the ``final-E.dat`` interchange.

Tolerances:
- a training run: both packages start from the same ``default_rng`` draws
  and solve the same normal equations; the port sums Σ v vᵀ over the pairs
  and factors with LAPACK where JAX multiplies a dense 0/1 matrix and runs
  its own Cholesky loop, so the fp32 results differ in summation order.
  After three iterations the tables and E agree to rtol 1e-4 of each
  table's largest entry (on the WMF fold each package lies about 5e-5 from
  a float64 solve of the same iterations, and 2e-5 from the other, for
  entries up to 1.05), and the ``state.log`` likelihoods to rtol 1e-4;
- the E-solves on the same inputs: rtol 1e-4, atol 1e-6 (JAX's
  Woodbury-CG stops at a relative residual of 1e-6; the port's Cholesky
  factor and both packages' LU solve the same system exactly in float32);
- ``.dat`` files hold six decimals: atol 6e-7, plus rtol 2e-7 for the
  fp32 rounding of the value read back (E has entries near 30).
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topk_rec_tpu.data.dataset import (
    Interactions,
    synthetic_features,
    synthetic_interactions,
)
from topk_rec_tpu.models import CER as JaxCER
from topk_rec_tpu.models import WMF as JaxWMF
from topk_rec_tpu.models import cer as jcer
from topk_rec_torch.data import Interactions as PortInteractions
from topk_rec_torch.models import CER, WMF
from topk_rec_torch.models import cer as tcer

SOLVE_TOL = dict(rtol=1e-4, atol=1e-6)
DAT_TOL = dict(rtol=2e-7, atol=6e-7)


def _port(inter):
    """The port's own Interactions over the same arrays as ``inter``."""
    return PortInteractions(inter.n_users, inter.n_items, inter.pos_u,
                            inter.pos_i, inter.seen_u, inter.seen_i)


@pytest.fixture(scope="module")
def cold_fold():
    """tests/test_models.py:178-193: 150 users x 100 items whose last 20
    items nobody rated in training, and features that predict them."""
    inter = synthetic_interactions(150, 100, 3000, seed=21)
    om = np.isin(inter.pos_i, np.arange(80, 100))
    tr = Interactions(inter.n_users, inter.n_items, inter.pos_u[~om],
                      inter.pos_i[~om])
    return tr, inter


def _close(got, want, **kw):
    """rtol 1e-4 of the table's largest entry."""
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()), **kw)


def _features(inter, d):
    return synthetic_features(inter, d=d, seed=3)


def _state_log(log_dir):
    with open(os.path.join(log_dir, "state.log")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "iter time likelihood converge"
    rows = [ln.split() for ln in lines[1:]]
    return [r[0] for r in rows], np.array([[float(r[2]), float(r[3])]
                                           for r in rows])


def _settings(log_dir):
    with open(os.path.join(log_dir, "settings.txt")) as f:
        return f.read()


def _check_logs(got_dir, want_dir, n_iter):
    got_it, got = _state_log(got_dir)
    want_it, want = _state_log(want_dir)
    assert got_it == want_it == ["%04d" % i for i in range(n_iter)]
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)
    assert _settings(got_dir) == _settings(want_dir)


def _check_dumps(got_dir, want_dir, n_iter):
    names = sorted(n for n in os.listdir(want_dir) if n[:4].isdigit())
    assert names == sorted(f"{i:04d}-{s}.dat" for i in range(n_iter)
                           for s in "UV")
    assert sorted(n for n in os.listdir(got_dir) if n[:4].isdigit()) == names
    for name in names:
        _close(np.loadtxt(os.path.join(got_dir, name)),
               np.loadtxt(os.path.join(want_dir, name)), err_msg=name)


@pytest.mark.parametrize("with_theta", [False, True])
def test_wmf_train_equals_jax(cold_fold, tmp_path, with_theta):
    """Three iterations from the same init, with and without the cr
    solver's theta prior: tables, state.log, settings.txt, save_lag dumps."""
    tr, _ = cold_fold
    k = 8
    theta = (np.random.default_rng(30).normal(size=(tr.n_items, k))
             .astype(np.float32) if with_theta else None)
    extra = {} if theta is None else {"theta": theta}
    runs = {}
    for name, cls, kw in (("jax", JaxWMF, {}), ("port", WMF,
                                                {"device": "cpu"})):
        m = cls(k=k, seed=7, block_size=64, **kw)
        m.set_interactions(tr if name == "jax" else _port(tr))
        out = str(tmp_path / name)
        m.train(max_iter=3, tol=0.0, verbose=False, log_dir=out,
                save_lag=1, save_dir=out, **extra)
        runs[name] = (m, out)
    (jm, jdir), (tm, tdir) = runs["jax"], runs["port"]
    assert type(tm.fue) is np.ndarray and type(tm.fie) is np.ndarray
    _close(tm.fue, jm.fue)
    _close(tm.fie, jm.fie)
    _check_logs(tdir, jdir, 3)
    _check_dumps(tdir, jdir, 3)
    tm.fue[0, 0] = 123.0  # writable host arrays, as JAX's
    # WMF has no state beyond its tables: no checkpoint.npz, as JAX
    tm.export_embeddings(str(tmp_path / "exp"))
    assert sorted(os.listdir(tmp_path / "exp")) == ["final-U.dat",
                                                    "final-V.dat"]


def test_wmf_theta_prior_and_loss(cold_fold):
    """theta initializes V and enters the item solve as the lv-weighted
    prior (the port's one iteration equals a manual sweep with that prior),
    and the loss's item term becomes 0.5·lv·‖V − θ‖²."""
    tr, _ = cold_fold
    k = 6
    theta = np.random.default_rng(31).normal(size=(tr.n_items, k)).astype(
        np.float32)
    model = WMF(k=k, seed=7, block_size=64, device="cpu")
    model.set_interactions(_port(tr))
    model.train(max_iter=1, tol=0.0, theta=theta, verbose=False)
    ref = WMF(k=k, seed=7, block_size=64, device="cpu")
    ref.set_interactions(_port(tr))
    ref.fie = theta.copy()
    ref._sweeps(prior=torch.from_numpy(theta))
    ref._sync_host()
    np.testing.assert_array_equal(model.fue, ref.fue)
    np.testing.assert_array_equal(model.fie, ref.fie)
    th = torch.from_numpy(theta)
    t = ref.tables
    want = (0.5 * ref.lu * float((t.U.double() ** 2).sum())
            + 0.5 * ref.lv * float(((t.V - th).double() ** 2).sum()))
    np.testing.assert_allclose(float(ref._loss_reg(th)), want, rtol=1e-5)
    want0 = (0.5 * ref.lu * float((t.U.double() ** 2).sum())
             + 0.5 * ref.lv * float((t.V.double() ** 2).sum()))
    np.testing.assert_allclose(float(ref._loss_reg()), want0, rtol=1e-5)
    with pytest.raises(ValueError, match="theta shape"):
        model.train(max_iter=1, theta=theta[:, :3], verbose=False)
    with pytest.raises(ValueError, match="no training data"):
        WMF(k=4, device="cpu").train(max_iter=1)


@pytest.mark.parametrize("d,route", [(40, "direct"), (128, "cg")])
def test_cer_train_equals_jax(cold_fold, tmp_path, d, route):
    """Three iterations from the same init on both E routes (d ≤ n_items:
    the d×d solve; d > n_items, "cg": the Woodbury form, which the port
    solves on its Cholesky factor and JAX, held to its exact route, by LU),
    then the cold-start write-back fie[unrated] = (F·E)[unrated]."""
    tr, full = cold_fold
    feat = _features(full, d)
    runs = {}
    for name, cls, kw in (("jax", JaxCER, {}), ("port", CER,
                                                {"device": "cpu"})):
        m = cls(k=8, d=d, lv=10.0, le=100.0, seed=11, block_size=64, **kw)
        m.set_interactions(tr if name == "jax" else _port(tr))
        m.set_features(feat)
        if name == "jax":
            m._e_solver_use_direct = True  # JAX's exact Woodbury solve
        out = str(tmp_path / name)
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # the port's factor: no fallback
            m.train(max_iter=3, tol=0.0, verbose=False, log_dir=out,
                    save_lag=1, save_dir=out)
        runs[name] = (m, out)
    (jm, jdir), (tm, tdir) = runs["jax"], runs["port"]
    assert tm.e_solver_steps == 0
    assert not tm._e_solver_use_direct
    _close(tm.E, jm.E)
    _close(tm.fue, jm.fue)
    _close(tm.fie, jm.fie)
    _check_logs(tdir, jdir, 3)
    _check_dumps(tdir, jdir, 3)
    unrated = np.setdiff1d(np.arange(tr.n_items), tr.rated_items)
    assert unrated.size >= 20
    np.testing.assert_allclose(tm.fie[unrated], (feat @ tm.E)[unrated],
                               rtol=1e-5, atol=1e-5)
    # released
    assert tm._feat_dev is None and tm._factor is None
    assert tm._gram_items is None


def test_cer_factors_once_a_call(cold_fold, monkeypatch):
    """d > n_items: each ``train`` call factors le·I + lv·F·Fᵀ once, in its
    first E-solve, and releases the factor; two calls from the same tables
    give the same tables, bitwise."""
    tr, full = cold_fold
    d = 128
    calls = []
    factor = tcer._woodbury_factor

    def counted(G, lv, le):
        calls.append(G.shape)
        return factor(G, lv, le)

    monkeypatch.setattr(tcer, "_woodbury_factor", counted)
    m = CER(k=8, d=d, lv=10.0, le=100.0, seed=11, block_size=64,
            device="cpu")
    m.set_interactions(_port(tr))
    m.set_features(_features(full, d))
    U0, V0 = m.fue.copy(), m.fie.copy()
    tables = []
    for _ in range(2):
        m.fue, m.fie, m.E = U0.copy(), V0.copy(), None
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            m.train(max_iter=3, tol=0.0, verbose=False)
        assert m._factor is None and m._gram_items is None
        tables.append((m.fue.copy(), m.fie.copy(), m.E.copy()))
    assert calls == [(tr.n_items, tr.n_items)] * 2
    for got, want in zip(tables[1], tables[0]):
        np.testing.assert_array_equal(got, want)


def test_cer_final_e_interchange(cold_fold, tmp_path):
    """final-E.dat both ways; CER writes no checkpoint.npz, as JAX."""
    tr, full = cold_fold
    feat = _features(full, 40)

    def make(cls, **kw):
        m = cls(k=6, d=40, seed=12, block_size=64, **kw)
        m.set_interactions(tr if cls is JaxCER else _port(tr))
        m.set_features(feat)
        return m

    port = make(CER, device="cpu")
    port.train(max_iter=2, verbose=False)
    port.export_embeddings(str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == [
        "final-E.dat", "final-U.dat", "final-V.dat"]
    jm = make(JaxCER)
    jm.import_embeddings(str(tmp_path / "port"))
    np.testing.assert_allclose(jm.E, port.E, **DAT_TOL)
    np.testing.assert_allclose(jm.fie, port.fie, **DAT_TOL)

    jm2 = make(JaxCER)
    jm2.train(max_iter=2, verbose=False)
    jm2.export_embeddings(str(tmp_path / "jax"))
    back = make(CER, device="cpu")
    back.import_embeddings(str(tmp_path / "jax"))
    np.testing.assert_allclose(back.E, jm2.E, **DAT_TOL)
    np.testing.assert_allclose(back.fue, jm2.fue, **DAT_TOL)
    # a warm start from the JAX files continues from its E, as JAX does
    warm_j, warm_t = make(JaxCER), make(CER, device="cpu")
    for m in (warm_j, warm_t):
        m.train(max_iter=1, tol=0.0, verbose=False,
                model_path=str(tmp_path / "jax"))
    _close(warm_t.E, warm_j.E)
    _close(warm_t.fie, warm_j.fie)


def _ridge_case(n_items=24, d=64, k=6, seed=5):
    rng = np.random.default_rng(seed)
    F = rng.standard_normal((n_items, d)).astype(np.float32)
    Y = rng.standard_normal((n_items, k)).astype(np.float32)
    return F, Y


@pytest.mark.parametrize("solver", ["direct", "woodbury_cg",
                                    "woodbury_direct"])
def test_ridge_solves_equal_jax(solver):
    """Each route of the port against JAX's. "woodbury_cg": the port's
    solve on the Cholesky factor of le·I + lv·G, with A formed in G's
    memory, against JAX's exact Woodbury solve and its CG (run to a
    relative residual of 1e-6)."""
    lv, le = 10.0, 1e4
    F, Y = _ridge_case()
    Fj, Yj = jnp.asarray(F), jnp.asarray(Y)
    Ft, Yt = torch.from_numpy(F), torch.from_numpy(Y)
    if solver == "direct":
        want = jcer._ridge_direct(Fj, Yj, lv, le)
        got = tcer._ridge_direct(Ft, Yt, lv, le)
    elif solver == "woodbury_cg":
        want = jcer._ridge_woodbury_direct(Fj, Fj @ Fj.T, Yj, lv, le)
        want_cg, want_rel = jcer._ridge_woodbury_cg(Fj, Fj @ Fj.T, Yj, lv,
                                                    le, 60)
        assert float(want_rel) <= 1e-6
        G = Ft @ Ft.T
        A = le * torch.eye(G.shape[0]) + lv * G
        L, info = tcer._woodbury_factor(G, lv, le)
        assert info == 0
        torch.testing.assert_close(G, A)  # A took G's memory
        torch.testing.assert_close(L @ L.T, A)
        got = tcer._ridge_woodbury_factored(Ft, L, Yt, lv)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_cg),
                                   **SOLVE_TOL)
    else:
        want = jcer._ridge_woodbury_direct(Fj, Fj @ Fj.T, Yj, lv, le)
        got = tcer._ridge_woodbury_direct(Ft, Ft @ Ft.T, Yt, lv, le)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SOLVE_TOL)


def test_cer_e_solve_nonconvergence_falls_back():
    """A Woodbury matrix with no Cholesky factor (le = -1e4 makes
    le·I + lv·F·Fᵀ negative definite) warns and is solved by LU, as JAX's
    exact route, for this feature set from then on; ``set_features``
    gives the factor a fresh chance. A healthy le factors with no
    warning."""
    n_items, d, k = 24, 64, 6
    F, Y = _ridge_case(n_items, d, k)
    model = CER(k=k, d=d, lv=10.0, le=-1e4, seed=1, device="cpu")
    model.n_items = n_items
    model.set_features(F)
    Yt = torch.from_numpy(Y)
    with pytest.warns(RuntimeWarning, match="no Cholesky factor"):
        E = model._solve_E(Yt).numpy()
    Fj = jnp.asarray(F)
    exact = np.asarray(jcer._ridge_woodbury_direct(
        Fj, Fj @ Fj.T, jnp.asarray(Y), model.lv, model.le))
    np.testing.assert_allclose(E, exact, **SOLVE_TOL)
    assert model._e_solver_use_direct and model._factor is None
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the verdict is cached: no factor
        np.testing.assert_array_equal(model._solve_E(Yt).numpy(), E)
    assert model.e_solver_steps == 0

    model.set_features(F)
    assert not model._e_solver_use_direct
    assert model._factor is None and model._gram_items is None
    model.le = 1e4
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        E2 = model._solve_E(Yt).numpy()
    assert model._factor is not None and model._gram_items is None
    assert model.e_solver_steps == 0
    exact2 = np.asarray(jcer._ridge_direct(Fj, jnp.asarray(Y), model.lv,
                                           model.le))
    np.testing.assert_allclose(E2, exact2, **SOLVE_TOL)


def test_cer_needs_features():
    m = CER(k=4, d=8, device="cpu")
    with pytest.raises(ValueError, match="features"):
        m.train(max_iter=1)


def test_load_content_data_equals_jax(tmp_path):
    """Features through the shared ``load_features``: rows re-ordered to
    the item index, zero rows for items the feature file lacks, ``d`` set
    from the file (or checked against the model's), as the JAX model."""
    import pickle

    rng = np.random.default_rng(9)
    iids = {f"v{i}": i for i in range(12)}
    feat_ids = [f"v{i}" for i in (5, 0, 11, 3, 7, 2, 9)]  # 7 of 12, shuffled
    (tmp_path / "fid").write_text("\n".join(feat_ids) + "\n")
    rows = rng.normal(size=(len(feat_ids), 6)).astype(np.float32)
    with open(tmp_path / "meta.pkl", "wb") as f:
        pickle.dump(rows, f)
    got = {}
    for name, model in (("jax", JaxCER(k=4, d=6)),
                        ("port", CER(k=4, d=6, device="cpu"))):
        model.iids = iids
        model.load_content_data(str(tmp_path / "meta.pkl"),
                                str(tmp_path / "fid"))
        got[name] = model.feat
        assert model.d == 6 and model.feat.dtype == np.float32
    np.testing.assert_array_equal(got["port"], got["jax"])
    np.testing.assert_array_equal(got["port"][11], rows[2])
    assert not got["port"][1].any()
    with pytest.raises(ValueError, match="load_training_data"):
        CER(k=4, d=6, device="cpu").load_content_data(
            str(tmp_path / "meta.pkl"), str(tmp_path / "fid"))
