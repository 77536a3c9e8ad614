"""The port's content encoders against the JAX package's: predictions and
fit sweeps from carried-over weights, the RMSProp update with eps inside
the square root, the denoising pretraining epoch fed JAX's masks, the
state round trip and the device feature cache.

Tolerances:
- ``predict`` from the same weights: rtol 1e-5 (atol 1e-6 for outputs
  near zero); both run the same fp32 products, summed in another order;
- fit sweeps, pretraining epochs and whole pretrainings: the losses rtol
  1e-4, the parameters and accumulators rtol 1e-4 with an atol of 1e-4
  times each array's largest magnitude (the updates of three sweeps carry
  the fp32 summation-order differences of every step);
- the state round trip is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topk_rec_tpu.models import MLPEncoder as JaxMLP
from topk_rec_tpu.models import SDAEEncoder as JaxSDAE
from topk_rec_tpu.models import encoders as jenc
from topk_rec_torch.interop import encoder_from_jax, encoder_to_jax
from topk_rec_torch.models import MLPEncoder, SDAEEncoder
from topk_rec_torch.models import encoders as tenc

HIDDEN = (32, 16)


def _toy_regression(n=100, d=24, k=6, seed=0):
    """n = 100 rows: not a multiple of the batch of 32 (four padding
    rows in every sweep)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(d, k)).astype(np.float32)
    Y = np.tanh(X @ W) + 0.05 * rng.normal(size=(n, k)).astype(np.float32)
    return X, Y.astype(np.float32)


def _pair(jax_cls, port_cls, **kw):
    """A JAX encoder and the port's, holding the JAX one's weights."""
    j = jax_cls(**kw)
    t = port_cls(**kw, device="cpu")
    encoder_from_jax(t, j)
    return j, t


def _close_state(got, want):
    assert sorted(got) == sorted(want)
    for name in want:
        w = np.asarray(want[name])
        np.testing.assert_allclose(
            got[name], w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()),
            err_msg=name)


def jax_pretrain_masks(seed, dims, epochs, n, batch_size, corrupt):
    """The keep-masks ``SDAEEncoder.pretrain`` of the JAX package draws
    inside ``_dae_pretrain_epoch`` (encoders.py:306-310, 385-406), one bool
    tensor [n_batches, batch, d_in] per (hidden layer, epoch), in order."""
    n_batches = -(-n // batch_size)
    pkey = jax.random.PRNGKey(seed + 1)
    out = []
    for d_in in dims[:-2]:
        key = jax.random.PRNGKey(
            int(jax.random.randint(pkey, (), 0, 2**31 - 1)))
        pkey, _ = jax.random.split(pkey)
        for _ in range(epochs):
            key, sub = jax.random.split(key)
            keys = jax.random.split(sub, n_batches)
            p = 1.0 - jnp.float32(corrupt)
            out.append(torch.from_numpy(np.stack([
                np.asarray(jax.random.bernoulli(kk, p, (batch_size, d_in)))
                for kk in keys])))
    return out


def feed_masks(monkeypatch, enc, masks):
    """Make the port's ``enc`` draw ``masks`` in order."""
    stream = iter(masks)

    def draw(n_batches, d_in):
        m = next(stream)
        assert m.shape == (n_batches, enc.batch_size, d_in)
        return m

    monkeypatch.setattr(enc, "_draw_masks", draw)


def test_mlp_predict_equals_jax():
    X, _ = _toy_regression()
    j, t = _pair(JaxMLP, MLPEncoder, k=6, d=24, hidden_layers=HIDDEN, seed=3)
    got = t.predict(X)
    assert type(got) is np.ndarray and got.shape == (100, 6)
    np.testing.assert_allclose(got, j.predict(X), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batch_size", [32, 7])
def test_mlp_fit_sweeps_equal_jax(batch_size):
    """Three shuffled sweeps from the same weights and seed: the same
    permutations (np.random.default_rng), losses and parameters."""
    X, Y = _toy_regression()
    j, t = _pair(JaxMLP, MLPEncoder, k=6, d=24, hidden_layers=HIDDEN, seed=3,
                 lr=1e-2, batch_size=batch_size)
    for _ in range(3):
        np.testing.assert_allclose(t.fit(X, Y), j.fit(X, Y), rtol=1e-4)
    _close_state(t.state_dict(), j.state_dict())
    np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=1e-4,
                               atol=1e-5)


def test_rmsprop_eps_inside_the_square_root():
    """p −= lr·g/sqrt(m + 1e-10): with gradients near 1e-6 the eps inside
    the root sets the step; torch.optim.RMSprop's sqrt(m) + eps would take
    steps ~30 times larger. A whole fit sweep on such data equals JAX's."""
    g = torch.full((5,), 1e-6)
    p, m = torch.zeros(5), torch.zeros(5)
    tenc._rmsprop_([p], [g], [m], lr=1e-2)
    want = -1e-2 * 1e-6 / np.sqrt(0.1 * 1e-12 + 1e-10)
    np.testing.assert_allclose(p.numpy(), want, rtol=1e-6)
    q = torch.zeros(5, requires_grad=True)
    opt = torch.optim.RMSprop([q], lr=1e-2, alpha=0.9, eps=1e-10)
    q.grad = g.clone()
    opt.step()
    assert float(q.detach().abs().min()) > 25 * float(p.abs().max())

    X, Y = _toy_regression()
    X, Y = X * 1e-4, Y * 1e-4  # gradients of order 1e-6 and below
    j, t = _pair(JaxMLP, MLPEncoder, k=6, d=24, hidden_layers=HIDDEN, seed=4,
                 lr=1e-2, batch_size=32)
    for _ in range(2):
        np.testing.assert_allclose(t.fit(X, Y), j.fit(X, Y), rtol=1e-4)
    _close_state(t.state_dict(), j.state_dict())


def test_state_round_trips_jax_port_jax():
    X, Y = _toy_regression()
    j = JaxMLP(k=6, d=24, hidden_layers=HIDDEN, seed=5, lr=1e-2)
    j.fit(X, Y)  # non-zero accumulators
    t = MLPEncoder(k=6, d=24, hidden_layers=HIDDEN, seed=9, device="cpu")
    encoder_from_jax(t, j.state_dict())
    back = encoder_to_jax(t)
    assert sorted(back) == sorted(j.state_dict()) == [
        "W0", "W1", "W2", "b0", "b1", "b2", "mW0", "mW1", "mW2", "mb0", "mb1",
        "mb2"]
    j2 = JaxMLP(k=6, d=24, hidden_layers=HIDDEN, seed=6)
    j2.load_state_dict(back)
    for name, a in j.state_dict().items():
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name], a, err_msg=name)
        np.testing.assert_array_equal(j2.state_dict()[name], a, err_msg=name)
    with pytest.raises(ValueError, match="shape"):
        MLPEncoder(k=6, d=24, hidden_layers=(8,), device="cpu"
                   ).load_state_dict(back)


def test_glorot_init_is_seeded_and_bounded():
    a = MLPEncoder(k=6, d=24, hidden_layers=HIDDEN, seed=1, device="cpu")
    b = MLPEncoder(k=6, d=24, hidden_layers=HIDDEN, seed=1, device="cpu")
    c = MLPEncoder(k=6, d=24, hidden_layers=HIDDEN, seed=2, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    for i, (fi, fo) in enumerate(zip((24, 32, 16), (32, 16, 6))):
        W = sa[f"W{i}"]
        assert W.shape == (fi, fo)
        limit = np.sqrt(6.0 / (fi + fo))
        assert np.abs(W).max() <= limit and np.abs(W).max() > 0.8 * limit
        np.testing.assert_array_equal(W, sb[f"W{i}"])
        assert not np.array_equal(W, sc[f"W{i}"])
        assert not sa[f"b{i}"].any() and not sa[f"mW{i}"].any()


def _dae_inputs(n=100, d_in=24, d_out=16, batch_size=32, seed=2):
    rng = np.random.default_rng(seed)
    n_pad = n + (-n) % batch_size
    H = rng.normal(size=(n_pad, d_in)).astype(np.float32)
    ok = np.zeros(n_pad, np.float32)
    ok[:n] = 1.0
    W = (rng.normal(size=(d_in, d_out)) * 0.3).astype(np.float32)
    b = (rng.normal(size=d_out) * 0.1).astype(np.float32)
    return H, ok, W, b


@pytest.mark.parametrize("linear_out", [True, False])
def test_dae_pretrain_epoch_equals_jax(linear_out):
    """One denoising epoch of one layer, the port fed JAX's masks."""
    H, ok, W, b = _dae_inputs()
    if not linear_out:  # deeper layers see sigmoid activations
        H = 1.0 / (1.0 + np.exp(-H))
    B, corrupt, lr = 32, 0.3, 1e-2
    Wd, bd = W.T.copy(), np.zeros(W.shape[0], np.float32)
    sub = jax.random.PRNGKey(11)
    want_p, want_ms, want_loss = jenc._dae_pretrain_epoch(
        *map(jnp.asarray, (W, b, Wd, bd)),
        tuple(jnp.zeros_like(jnp.asarray(a)) for a in (W, b, Wd, bd)),
        jnp.asarray(H), jnp.asarray(ok), sub, corrupt, lr, batch_size=B,
        linear_out=linear_out)
    keys = jax.random.split(sub, H.shape[0] // B)
    masks = torch.from_numpy(np.stack([np.asarray(jax.random.bernoulli(
        kk, 1.0 - jnp.float32(corrupt), (B, W.shape[0]))) for kk in keys]))
    p = [torch.tensor(a, requires_grad=True) for a in (W, b, Wd, bd)]
    ms = [torch.zeros_like(t) for t in p]
    loss = tenc._dae_pretrain_epoch(
        p, ms, torch.from_numpy(H), torch.arange(H.shape[0]),
        torch.from_numpy(ok), masks, lr, B, linear_out)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    for name, g, w in zip(("W", "b", "Wd", "bd", "mW", "mb", "mWd", "mbd"),
                          p + ms, list(want_p) + list(want_ms)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=name)


def test_sdae_pretrain_fed_jax_masks_equals_jax(monkeypatch):
    """The whole layer-wise pretraining, two epochs per hidden layer: the
    same shuffles from the shared ``_rng``, the decoder from Wᵀ, a linear
    layer-0 decoder, clean activations into the next layer, zeroed
    accumulators, then a fit sweep drawing the next permutation."""
    X, Y = _toy_regression()
    kw = dict(k=6, d=24, hidden_layers=HIDDEN, seed=3, batch_size=32,
              pretrain_epochs=2, pretrain_lr=1e-2)
    j, t = _pair(JaxSDAE, SDAEEncoder, **kw)
    feed_masks(monkeypatch, t, jax_pretrain_masks(
        3, (24, *HIDDEN, 6), 2, 100, 32, t.corrupt))
    j.pretrain(X)
    t.pretrain(X)
    np.testing.assert_allclose(t.pretrain_losses, j.pretrain_losses,
                               rtol=1e-4)
    _close_state(t.state_dict(), j.state_dict())
    np.testing.assert_allclose(t.fit(X, Y), j.fit(X, Y), rtol=1e-4)
    _close_state(t.state_dict(), j.state_dict())


def test_sdae_pretrain_lowers_reconstruction_loss():
    """The port's own masks: each hidden layer's denoising loss falls."""
    X, _ = _toy_regression()
    enc = SDAEEncoder(k=6, d=24, hidden_layers=HIDDEN, seed=1, batch_size=32,
                      pretrain_epochs=4, pretrain_lr=1e-2, device="cpu")
    before = enc.state_dict()
    enc.pretrain(X)
    assert len(enc.pretrain_losses) == 2
    for losses in enc.pretrain_losses:
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    after = enc.state_dict()
    assert not np.array_equal(after["W0"], before["W0"])
    np.testing.assert_array_equal(after["W2"], before["W2"])  # output layer
    assert not after["mW0"].any() and not after["mb1"].any()
    masks = enc._draw_masks(50, 24)
    assert masks.dtype == torch.bool and masks.shape == (50, 32, 24)
    assert abs(float(masks.float().mean()) - 0.7) < 0.01


def test_feature_cache_pinned_released_and_checked():
    """The device copy is keyed on the array, pins it, is released by
    drop_feature_cache, and raises when the array changed in place."""
    enc = MLPEncoder(k=3, d=8, hidden_layers=(6,), seed=0, device="cpu")
    rng = np.random.default_rng(0)
    X1 = rng.normal(size=(10, 8)).astype(np.float32)
    p1 = enc.predict(X1)
    assert enc._x_cache_src is X1
    cached = enc._x_cache
    assert cached.data_ptr() != torch.from_numpy(X1).data_ptr()  # a copy
    enc.predict(X1)
    assert enc._x_cache is cached  # a hit: no new upload
    X2 = rng.normal(size=(10, 8)).astype(np.float32)
    p2 = enc.predict(X2)
    assert enc._x_cache_src is X2 and not np.allclose(p1, p2)
    enc.drop_feature_cache()
    assert enc._x_cache is None and enc._x_cache_src is None
    np.testing.assert_array_equal(enc.predict(X2), p2)
    X2[9, 7] += 1.0  # the last of the 16 probed elements
    with pytest.raises(ValueError, match="mutated in place"):
        enc.predict(X2)
    np.testing.assert_array_equal(enc.predict(torch.from_numpy(X1)), p1)
    enc.drop_feature_cache()
    Xt = np.asfortranarray(rng.normal(size=(10, 8)).astype(np.float32))
    np.testing.assert_allclose(enc.predict(Xt),
                               enc.predict(np.ascontiguousarray(Xt)),
                               rtol=1e-6)
