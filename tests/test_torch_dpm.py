"""The port's DPM against the JAX package's: whole training runs from the
same WMF init and the same encoder weights (the SDAE's pretraining fed
JAX's masks), ``fit_batch``, the cold-start write-back, ``checkpoint.npz``
both ways, and trained against untrained accuracy on cold items.

Tolerances:
- a training run: the tables after the cold-start write-back, every
  ``save_lag`` dump and the trained encoder's predictions agree to rtol
  1e-4 of each array's largest entry, and the ``state.log`` likelihoods to
  rtol 1e-4. Both packages start from the same draws; they differ in fp32
  summation order (the ALS sums, the products of the encoder). The runs
  use lu = 1: the untrained encoder's Fe is nearly rank one (singular
  values 17.7 down to 0.01 on this fold), so at the reference's lu = 0.01
  the first user solve has a condition number near 1e6 and each package
  lies ~7e-4 from a float64 solve of it, 3.8e-4 from the other;
- ``.dat`` files hold six decimals: atol 6e-7, plus rtol 2e-7;
- the checkpoint's arrays pass exactly.
"""

import os

import numpy as np
import pytest

from test_torch_encoders import feed_masks, jax_pretrain_masks
from topk_rec_tpu.data.dataset import (
    Interactions,
    synthetic_features,
    synthetic_interactions,
)
from topk_rec_tpu.eval import evaluate_oracle
from topk_rec_tpu.models import DPM as JaxDPM
from topk_rec_tpu.models import MLPEncoder as JaxMLP
from topk_rec_tpu.models import SDAEEncoder as JaxSDAE
from topk_rec_torch.data import Interactions as PortInteractions
from topk_rec_torch.interop import dpm_from_jax, encoder_from_jax
from topk_rec_torch.models import DPM, MLPEncoder, SDAEEncoder

D, K, HIDDEN = 24, 8, (32, 16)
DAT_TOL = dict(rtol=2e-7, atol=6e-7)


def _port(inter):
    return PortInteractions(inter.n_users, inter.n_items, inter.pos_u,
                            inter.pos_i, inter.seen_u, inter.seen_i)


@pytest.fixture(scope="module")
def cold_fold():
    """120 users x 80 items whose last 16 items nobody rated in training,
    with d = 24 features that predict every item's likes."""
    inter = synthetic_interactions(120, 80, 1800, seed=21)
    om = inter.pos_i >= 64
    tr = Interactions(inter.n_users, inter.n_items, inter.pos_u[~om],
                      inter.pos_i[~om])
    feat = synthetic_features(inter, d=D, seed=3)
    feat = feat / np.abs(feat).max()
    return tr, inter, feat


def _close(got, want, **kw):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()), **kw)


def _likelihoods(log_dir):
    with open(os.path.join(log_dir, "state.log")) as f:
        lines = f.read().splitlines()
    assert lines[0] == "iter time likelihood converge"
    return [ln.split()[0] for ln in lines[1:]], np.array(
        [float(ln.split()[2]) for ln in lines[1:]])


def _encoders(kind, seed=3):
    kw = dict(k=K, d=D, hidden_layers=HIDDEN, seed=seed, batch_size=32,
              lr=1e-3)
    if kind == "sdae":
        kw.update(pretrain_epochs=2, pretrain_lr=1e-2)
        j = JaxSDAE(**kw)
        t = SDAEEncoder(**kw, device="cpu")
    else:
        j = JaxMLP(**kw)
        t = MLPEncoder(**kw, device="cpu")
    encoder_from_jax(t, j)
    return j, t


@pytest.mark.parametrize("kind,fit_batch", [("mlp", None), ("sdae", None),
                                            ("mlp", 16)])
def test_dpm_train_equals_jax(cold_fold, tmp_path, monkeypatch, kind,
                              fit_batch):
    """Three iterations: tables, state.log, settings.txt, the save_lag
    dumps and the encoder; ``fit_batch`` overrides the encoder's batch."""
    tr, _, feat = cold_fold
    j_enc, t_enc = _encoders(kind)
    if kind == "sdae":
        feed_masks(monkeypatch, t_enc, jax_pretrain_masks(
            3, (D, *HIDDEN, K), 2, tr.n_items, 32, t_enc.corrupt))
    runs = {}
    for name, model, enc in (
            ("jax", JaxDPM(k=K, d=D, lu=1.0, seed=7, block_size=64), j_enc),
            ("port", DPM(k=K, d=D, lu=1.0, seed=7, block_size=64,
                         device="cpu"), t_enc)):
        model.set_interactions(tr if name == "jax" else _port(tr))
        model.set_features(feat)
        out = str(tmp_path / name)
        model.train(enc, max_iter=3, verbose=False, log_dir=out, save_lag=1,
                    save_dir=out, fit_batch=fit_batch)
        runs[name] = (model, out)
    (jm, jdir), (tm, tdir) = runs["jax"], runs["port"]
    assert tm.encoder is t_enc and t_enc.batch_size == (fit_batch or 32)
    assert type(tm.fue) is np.ndarray and type(tm.fie) is np.ndarray
    _close(tm.fue, jm.fue)
    _close(tm.fie, jm.fie)
    got_it, got = _likelihoods(tdir)
    want_it, want = _likelihoods(jdir)
    assert got_it == want_it == ["0000", "0001", "0002"]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for name in ("settings.txt",) + tuple(f"{i:04d}-{s}.dat" for i in range(3)
                                          for s in "UV"):
        if name.endswith(".dat"):
            _close(np.loadtxt(os.path.join(tdir, name)),
                   np.loadtxt(os.path.join(jdir, name)), err_msg=name)
        else:
            assert open(os.path.join(tdir, name)).read() == \
                open(os.path.join(jdir, name)).read()
    assert t_enc._x_cache is None  # the feature cache was released
    _close(t_enc.predict(feat), j_enc.predict(feat))
    if kind == "sdae":
        np.testing.assert_allclose(t_enc.pretrain_losses,
                                   j_enc.pretrain_losses, rtol=1e-4)


def test_cold_start_write_back(cold_fold):
    """Items nobody rated take the final encoder's prediction; rated items
    keep the tables' V; with max_iter = 0 U keeps its init."""
    tr, _, feat = cold_fold
    model = DPM(k=K, d=D, seed=2, block_size=64, device="cpu")
    model.set_interactions(_port(tr))
    model.set_features(feat)
    model.train(MLPEncoder(K, D, hidden_layers=HIDDEN, seed=1, device="cpu"),
                max_iter=2, verbose=False)
    unrated = np.setdiff1d(np.arange(tr.n_items), tr.rated_items)
    assert unrated.size >= 16
    Fe = model.encoder.predict(feat)
    np.testing.assert_array_equal(model.fie[unrated], Fe[unrated])
    V = model.tables.V.numpy()
    np.testing.assert_array_equal(model.fie[tr.rated_items],
                                  V[tr.rated_items])
    assert not np.array_equal(model.fie[unrated], V[unrated])

    init = DPM(k=K, d=D, seed=2, block_size=64, device="cpu")
    init.set_interactions(_port(tr))
    init.set_features(feat)
    fue0 = init.fue.copy()
    init.train(MLPEncoder, max_iter=0, verbose=False)
    assert isinstance(init.encoder, MLPEncoder)  # built from the class
    assert init.encoder.device.type == "cpu"
    np.testing.assert_array_equal(init.fue, fue0)
    np.testing.assert_array_equal(init.fie[unrated],
                                  init.encoder.predict(feat)[unrated])
    with pytest.raises(ValueError, match="features"):
        DPM(k=K, d=D, device="cpu").train(MLPEncoder, max_iter=1)


def test_checkpoint_passes_both_ways(cold_fold, tmp_path):
    """checkpoint.npz under the JAX keys: the port's files load into a JAX
    DPM and the JAX files into the port's, and a warm start from the JAX
    files continues as JAX does."""
    tr, _, feat = cold_fold

    def make(cls, **kw):
        m = cls(k=K, d=D, lu=1.0, seed=4, block_size=64, **kw)
        m.set_interactions(tr if cls is JaxDPM else _port(tr))
        m.set_features(feat)
        return m

    port = make(DPM, device="cpu")
    port.train(MLPEncoder(K, D, hidden_layers=HIDDEN, seed=5, device="cpu"),
               max_iter=2, verbose=False)
    port.export_embeddings(str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == [
        "checkpoint.npz", "final-U.dat", "final-V.dat"]
    jm = make(JaxDPM)
    jm.encoder = JaxMLP(K, D, hidden_layers=HIDDEN, seed=8)
    jm.import_embeddings(str(tmp_path / "port"))
    jstate = jm.encoder.state_dict()
    for name, a in port.encoder.state_dict().items():
        np.testing.assert_array_equal(np.asarray(jstate[name]), a,
                                      err_msg=name)
    np.testing.assert_allclose(jm.fie, port.fie, **DAT_TOL)

    jm2 = make(JaxDPM)
    jm2.train(JaxMLP(K, D, hidden_layers=HIDDEN, seed=6), max_iter=2,
              verbose=False)
    jm2.export_embeddings(str(tmp_path / "jax"))
    back = make(DPM, device="cpu")
    back.encoder = MLPEncoder(K, D, hidden_layers=HIDDEN, seed=9,
                              device="cpu")
    back.import_embeddings(str(tmp_path / "jax"))
    for name, a in jm2.encoder.state_dict().items():
        np.testing.assert_array_equal(back.encoder.state_dict()[name],
                                      np.asarray(a), err_msg=name)
    np.testing.assert_allclose(back.fue, jm2.fue, **DAT_TOL)

    # a warm start loads the tables and, through checkpoint.npz, the encoder
    warm_j = make(JaxDPM)
    warm_t = make(DPM, device="cpu")
    warm_j.train(JaxMLP(K, D, hidden_layers=HIDDEN, seed=7), max_iter=1,
                 verbose=False, model_path=str(tmp_path / "jax"))
    warm_t.train(MLPEncoder(K, D, hidden_layers=HIDDEN, seed=7, device="cpu"),
                 max_iter=1, verbose=False, model_path=str(tmp_path / "jax"))
    _close(warm_t.fue, warm_j.fue)
    _close(warm_t.fie, warm_j.fie)


def test_dpm_from_jax(cold_fold):
    tr, _, feat = cold_fold
    jm = JaxDPM(k=K, d=D, seed=4, block_size=64)
    jm.set_interactions(tr)
    jm.set_features(feat)
    jm.train(JaxMLP(K, D, hidden_layers=HIDDEN, seed=6), max_iter=1,
             verbose=False)
    tm = DPM(k=K, d=D, seed=0, block_size=64, device="cpu")
    tm.set_interactions(_port(tr))
    tm.set_features(feat)
    dpm_from_jax(tm, jm)
    assert isinstance(tm.encoder, MLPEncoder) and tm.encoder.n_layers == 3
    np.testing.assert_array_equal(tm.fue, jm.fue)
    np.testing.assert_array_equal(tm.fie, jm.fie)
    np.testing.assert_allclose(tm.encoder.predict(feat),
                               jm.encoder.predict(feat), rtol=1e-5, atol=1e-6)


def _cold_accuracy(fue, fie, tr, full, total=10):
    """accuracy@5..total of the cold items' held-out likes, by the JAX
    package's oracle."""
    cold = np.arange(64, 80)
    likes = {}
    for u, i in zip(full.pos_u, full.pos_i):
        if i >= 64:
            likes.setdefault(int(u), []).append(int(i) - 64)
    S = fue @ fie[cold].T
    seen = np.zeros((tr.n_users, cold.size), bool)
    return evaluate_oracle(S, seen, likes, step=5, total=total).accuracy


def test_trained_beats_untrained_on_cold_items(cold_fold):
    """The encoder's prior carries the content to items nobody rated:
    after 5 iterations their held-out likes rank above those of the
    untrained tables (max_iter = 0)."""
    tr, full, feat = cold_fold
    acc = {}
    for n_iter in (0, 5):
        m = DPM(k=K, d=D, seed=1, block_size=64, device="cpu")
        m.set_interactions(_port(tr))
        m.set_features(feat)
        m.train(MLPEncoder(K, D, hidden_layers=HIDDEN, seed=2, lr=1e-3,
                           device="cpu"), max_iter=n_iter, verbose=False)
        acc[n_iter] = _cold_accuracy(m.fue, m.fie, tr, full)
    assert acc[5][-1] > acc[0][-1] + 0.05, acc
