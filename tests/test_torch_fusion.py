"""The port's late fusion against the JAX package's: every case of
``tests/test_fusion.py`` run on the port, the weight fits and the
score-difference precompute on the same inputs, the SVM and BPR weightings
on the same triplets, and ``topk_unseen_scorer`` / ``evaluate_fused``
against JAX and ``evaluate_oracle``.

Tolerances:
- ``error_weights``, ``_squared_hinge_fit``, ``_fusion_build_d``,
  ``_fusion_sgd`` and the SVM / BPR weightings on the same inputs: rtol
  1e-5 (atol 1e-7 where a value can sit near zero); the same fp32
  arithmetic summed in another order;
- the fused evaluations: hits equal (the scores are tie-free), the
  reciprocal ranks rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topk_rec_tpu.data.dataset import synthetic_interactions
from topk_rec_tpu.eval import evaluate_oracle
from topk_rec_tpu.eval import device as jdev
from topk_rec_tpu.fusion import ModalityScores as JaxModalities
from topk_rec_tpu.fusion import fusion as jfus
from topk_rec_torch.data import Interactions
from topk_rec_torch.eval import device as tdev
from topk_rec_torch.fusion import (
    ModalityScores,
    average_weights,
    bpr_fusion_weights,
    error_weights,
    evaluate_fused,
    rank_geometric_weights,
    svm_fusion_weights,
)
from topk_rec_torch.fusion import fusion as tfus
from topk_rec_torch.ops.topk_fused import pack_candidate_bitmap

FIT_TOL = dict(rtol=1e-5, atol=1e-7)


def _port(inter):
    return Interactions(inter.n_users, inter.n_items, inter.pos_u,
                        inter.pos_i, inter.seen_u, inter.seen_i)


@pytest.fixture(scope="module")
def modal_setup():
    """tests/test_fusion.py:19-33: one informative modality, one noise."""
    rng = np.random.default_rng(0)
    inter = synthetic_interactions(80, 60, 1200, seed=4)
    k = 8
    good = (inter._cache["u_lat"][:, :k].astype(np.float32),
            inter._cache["i_lat"][:, :k].astype(np.float32))
    noise = (rng.normal(size=(80, k)).astype(np.float32),
             rng.normal(size=(60, k)).astype(np.float32))
    return (_port(inter), ModalityScores([good, noise], device="cpu"),
            inter, JaxModalities([good, noise]), [good, noise])


def _dense_seen(inter):
    seen = np.zeros((inter.n_users, inter.n_items), bool)
    seen[inter.seen_u, inter.seen_i] = True
    return seen


def _fused_dense(embeddings, w):
    S = np.zeros((embeddings[0][0].shape[0], embeddings[0][1].shape[0]),
                 np.float32)
    for f, (U, V) in enumerate(embeddings):
        wf = w[:, f:f + 1] if np.ndim(w) == 2 else w[f]
        S += wf * (U @ V.T)
    return S


def test_weight_constructors():
    np.testing.assert_allclose(average_weights(4), [0.25] * 4)
    np.testing.assert_allclose(rank_geometric_weights(3, 0.5),
                               [0.5, 0.25, 0.125])
    for n, p in ((4, 0.3), (1, 0.9)):
        np.testing.assert_array_equal(rank_geometric_weights(n, p),
                                      jfus.rank_geometric_weights(n, p))
        np.testing.assert_array_equal(average_weights(n),
                                      jfus.average_weights(n))


def test_chunk_stack_matches_numpy(modal_setup):
    _, modalities, _, jm, emb = modal_setup
    cand = np.arange(10, 40)
    stack = modalities.chunk_stack(5, 25, cand).numpy()
    assert stack.shape == (20, 30, 2)
    for f, (U, V) in enumerate(emb):
        np.testing.assert_allclose(stack[:, :, f], U[5:25] @ V[cand].T,
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        stack, np.asarray(jm.chunk_stack(5, 25, jnp.asarray(cand))),
        rtol=1e-5, atol=1e-6)
    u, i = torch.tensor([0, 3, 79]), torch.tensor([1, 59, 0])
    np.testing.assert_allclose(
        modalities.sample_scores(u, i).numpy(),
        np.asarray(jm.sample_scores(jnp.asarray(u.numpy()),
                                    jnp.asarray(i.numpy()))), rtol=1e-5)


def test_error_weights_favor_calibrated_modality():
    rng = np.random.default_rng(7)
    inter = synthetic_interactions(50, 40, 600, seed=9)
    L = inter.dense_matrix()
    U_good = (L + 0.1 * rng.normal(size=L.shape)).astype(np.float32)
    V_good = np.eye(inter.n_items, dtype=np.float32)
    U_bad = rng.normal(size=(inter.n_users, 8)).astype(np.float32)
    V_bad = rng.normal(size=(inter.n_items, 8)).astype(np.float32)
    emb = [(U_good, V_good), (U_bad, V_bad)]
    w = error_weights(ModalityScores(emb, device="cpu"), _port(inter),
                      np.arange(inter.n_items), user_chunk=16)
    assert w.shape == (inter.n_users, 2)
    assert (w[:, 0] > w[:, 1]).mean() > 0.9
    want = jfus.error_weights(JaxModalities(emb), inter,
                              np.arange(inter.n_items), user_chunk=16)
    np.testing.assert_allclose(w, want, **FIT_TOL)


def test_error_weights_semantics_tiny():
    """Exact values of the reference formula (efusion.py:57-82), and a user
    with no likes keeps a zero row."""
    U1 = np.array([[1.0], [1.0]], dtype=np.float32)
    V1 = np.array([[0.9], [0.1]], dtype=np.float32)
    U2 = np.array([[1.0], [1.0]], dtype=np.float32)
    V2 = np.array([[0.0], [1.0]], dtype=np.float32)
    inter = Interactions(2, 2, np.array([0], np.int32),
                         np.array([0], np.int32))
    m = ModalityScores([(U1, V1), (U2, V2)], device="cpu")
    w = error_weights(m, inter, np.arange(2), user_chunk=8)
    r1, r2 = abs(0.9 - 1.0), abs(0.0 - 1.0)
    mean = (r1 + r2) / 2
    np.testing.assert_allclose(
        w[0], [np.exp(-(r1 - mean)), np.exp(-(r2 - mean))], rtol=1e-5)
    np.testing.assert_array_equal(w[1], [0.0, 0.0])


@pytest.mark.parametrize("cand", ["all", "subset"])
def test_error_weights_equal_jax(modal_setup, cand):
    """Over the full catalog and over a shuffled candidate subset, with
    ragged user chunks (the bitmap words expanded on the device)."""
    inter, modalities, jinter, jm, _ = modal_setup
    ids = (np.arange(jinter.n_items) if cand == "all"
           else np.random.default_rng(2).permutation(jinter.n_items)[:37])
    got = error_weights(modalities, inter, ids, user_chunk=23)
    want = jfus.error_weights(jm, jinter, ids, user_chunk=23)
    np.testing.assert_allclose(got, want, **FIT_TOL)


def _svm_inputs(n=3000, F=3, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    y = np.where(np.arange(n) % 2 == 0, 1.0, -1.0).astype(np.float32)
    X = X * y[:, None] + 0.3  # separable-ish with an offset
    return X, y


@pytest.mark.parametrize("C,n_iters", [(0.01, 200), (1.0, 60)])
def test_squared_hinge_fit_equals_jax(C, n_iters):
    X, y = _svm_inputs()
    want_w, want_loss = jfus._squared_hinge_fit(jnp.asarray(X), jnp.asarray(y),
                                                C, 0.05, n_iters)
    got_w, got_loss = tfus._squared_hinge_fit(torch.from_numpy(X),
                                              torch.from_numpy(y), C, 0.05,
                                              n_iters)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **FIT_TOL)
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)


def _triplets(inter, n, seed):
    """(u, i, j) with i a positive and j a negative of u."""
    rng = np.random.default_rng(seed)
    pos = set(zip(inter.pos_u.tolist(), inter.pos_i.tolist()))
    at = rng.integers(0, inter.nnz, size=n)
    u, i = inter.pos_u[at].astype(np.int64), inter.pos_i[at].astype(np.int64)
    j = rng.integers(0, inter.n_items, size=n)
    for r in range(n):
        while (int(u[r]), int(j[r])) in pos:
            j[r] = rng.integers(0, inter.n_items)
    return u, i, j


def _feed_triplets(monkeypatch, u, i, j):
    """Both packages' samplers hand out the same triplets."""
    class JaxFixed:
        def __init__(self, inter):
            pass

        def __call__(self, key, n):
            assert n == u.size
            return jnp.asarray(u), jnp.asarray(i), jnp.asarray(j)

    class PortFixed:
        def __init__(self, inter, device):
            self.device = device

        def __call__(self, gen, n):
            assert n == u.size
            return tuple(torch.from_numpy(a).to(self.device)
                         for a in (u, i, j))

    monkeypatch.setattr(jfus, "TripletSampler", JaxFixed)
    monkeypatch.setattr(tfus, "TripletSampler", PortFixed)


def test_svm_weights_equal_jax_on_the_same_triplets(modal_setup,
                                                    monkeypatch):
    inter, modalities, jinter, jm, _ = modal_setup
    u, i, j = _triplets(jinter, 4000, seed=3)
    _feed_triplets(monkeypatch, u, i, j)
    got = svm_fusion_weights(modalities, inter, n_samples=4000, n_iters=300)
    want = jfus.svm_fusion_weights(jm, jinter, n_samples=4000, n_iters=300)
    np.testing.assert_allclose(got, want, **FIT_TOL)
    assert got[0] > abs(got[1]) * 2


def test_bpr_weights_equal_jax_on_the_same_triplets(modal_setup,
                                                    monkeypatch):
    inter, modalities, jinter, jm, _ = modal_setup
    u, i, j = _triplets(jinter, 30_000, seed=4)
    _feed_triplets(monkeypatch, u, i, j)
    kw = dict(n_samples=30_000, batch_size=1000, lr=1e-3)
    got = bpr_fusion_weights(modalities, inter, **kw)
    want = jfus.bpr_fusion_weights(jm, jinter, **kw)
    np.testing.assert_allclose(got, want, **FIT_TOL)


def _mixed_widths(seed=4, n_u=50, n_i=40, widths=(6, 11, 3)):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(n_u, w)).astype(np.float32),
             rng.normal(size=(n_i, w)).astype(np.float32)) for w in widths]


def test_fusion_build_d_mixed_widths_equals_jax():
    """Modalities of widths 6, 11 and 3: each reduces its own column
    segment of the concatenated tables."""
    emb = _mixed_widths()
    Ucat = np.concatenate([U for U, _ in emb], 1)
    Vcat = np.concatenate([V for _, V in emb], 1)
    rng = np.random.default_rng(5)
    n_batches, batch = 6, 50
    u, i, j = (rng.integers(0, n, size=n_batches * batch)
               for n in (50, 40, 40))
    args = (4, (6, 11, 3), n_batches, batch)
    want = jfus._fusion_build_d(*map(jnp.asarray, (Ucat, Vcat, u, i, j)),
                                *args)
    got = tfus._fusion_build_d(*map(torch.from_numpy, (Ucat, Vcat, u, i, j)),
                               *args)
    assert got.shape == (n_batches, batch, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    manual = np.stack([(U[u] * (V[i] - V[j])).sum(1) for U, V in emb], -1)
    np.testing.assert_allclose(got.numpy().reshape(-1, 3), manual,
                               rtol=1e-5, atol=1e-5)


def test_fusion_sgd_equals_jax():
    rng = np.random.default_rng(6)
    d_all = rng.normal(size=(25, 200, 3)).astype(np.float32)
    w0 = np.array([0.1, -0.2, 0.05], np.float32)
    want_w, want_costs = jfus._fusion_sgd(jnp.asarray(d_all), jnp.asarray(w0),
                                          1e-3, 0.0025)
    got_w, got_costs = tfus._fusion_sgd(torch.from_numpy(d_all),
                                        torch.from_numpy(w0), 1e-3, 0.0025)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **FIT_TOL)
    np.testing.assert_allclose(got_costs.numpy(), np.asarray(want_costs),
                               rtol=1e-5)


def test_svm_weights_favor_good_modality(modal_setup):
    inter, modalities, *_ = modal_setup
    w = svm_fusion_weights(modalities, inter, n_samples=20_000, seed=1)
    assert w[0] > abs(w[1]) * 2, w


def test_bpr_weights_favor_good_modality(modal_setup):
    inter, modalities, *_ = modal_setup
    w = bpr_fusion_weights(modalities, inter, n_samples=200_000,
                           batch_size=5000, lr=1e-3, seed=2)
    assert w[0] > abs(w[1]) * 2, w


def test_bpr_fusion_heterogeneous_k():
    """tests/test_fusion.py:179-205 on the port: widths 6 and 11, the
    informative modality wins."""
    rng = np.random.default_rng(4)
    n_u, n_i = 120, 80
    jinter = synthetic_interactions(n_u, n_i, 1500, seed=5)
    U0 = rng.normal(size=(n_u, 6)).astype(np.float32)
    V0 = rng.normal(size=(n_i, 6)).astype(np.float32)
    for u, i in zip(jinter.pos_u.tolist(), jinter.pos_i.tolist()):
        V0[i] += 0.05 * U0[u]
    U1 = rng.normal(size=(n_u, 11)).astype(np.float32)
    V1 = rng.normal(size=(n_i, 11)).astype(np.float32)
    m = ModalityScores([(U0, V0), (U1, V1)], device="cpu")
    w = bpr_fusion_weights(m, _port(jinter), n_samples=40_000,
                           batch_size=2_000, lr=0.01, seed=0)
    assert w.shape == (2,) and np.all(np.isfinite(w))
    assert w[0] > w[1], w


def _likes(n_users, n_cand, every, per_user, seed):
    rng = np.random.default_rng(seed)
    return {u: [int(c) for c in rng.choice(n_cand, size=per_user,
                                           replace=False)]
            for u in range(0, n_users, every)}


@pytest.mark.parametrize("weights", ["global", "per_user"])
@pytest.mark.parametrize("want_rr", [False, True])
def test_evaluate_fused_equals_jax_and_oracle(modal_setup, weights, want_rr):
    """Hits (and with want_rr the reciprocal ranks) equal JAX's
    evaluate_fused and the oracle's on the dense fused matrix, over a
    shuffled candidate subset, in ragged user chunks."""
    inter, modalities, jinter, jm, emb = modal_setup
    rng = np.random.default_rng(3)
    cand = rng.permutation(jinter.n_items)[:45]
    likes = _likes(jinter.n_users, cand.size, 3, 2, seed=8)
    w = (np.array([0.7, 0.3], np.float32) if weights == "global"
         else rng.random((jinter.n_users, 2)).astype(np.float32))
    kw = dict(step=5, total=20, user_chunk=17, want_rr=want_rr)
    got = evaluate_fused(modalities, w, inter.seen_bitmap, cand, likes, **kw)
    want = jfus.evaluate_fused(jm, w, jinter.seen_bitmap, cand, likes, **kw)
    oracle = evaluate_oracle(_fused_dense(emb, w)[:, cand],
                             _dense_seen(jinter)[:, cand], likes, step=5,
                             total=20)
    np.testing.assert_array_equal(got.hits, want.hits)
    np.testing.assert_array_equal(got.hits, oracle.hits)
    assert got.count == want.count == oracle.count
    if want_rr:
        np.testing.assert_allclose(got.rr, oracle.rr, rtol=1e-6)
        np.testing.assert_allclose(got.rr, want.rr, rtol=1e-6)
    else:
        assert not got.rr.any()


def test_topk_unseen_scorer_equals_jax(modal_setup):
    """The chunk scorer's top-k, with a packed bitmap passed in and with
    one packed inside, and k above the candidate count."""
    inter, modalities, jinter, jm, _ = modal_setup
    cand = np.arange(jinter.n_items)[::-1].copy()
    w = np.array([0.4, 0.6], np.float32)
    packed = pack_candidate_bitmap(inter.seen_bitmap, cand)
    for k, pk in ((7, packed), (100, None)):
        got = tdev.topk_unseen_scorer(
            modalities.fused_scorer(w, cand), inter.n_users, cand.size,
            inter.seen_bitmap, cand, k, user_chunk=13, packed_seen=pk,
            device="cpu")
        want = jdev.topk_unseen_scorer(
            jm.fused_scorer(w, cand), jinter.n_users, cand.size,
            jinter.seen_bitmap, cand, k, user_chunk=13, packed_seen=pk)
        kk = min(k, cand.size)
        assert got[1].shape == (inter.n_users, kk)
        valid = np.isfinite(want[0])
        np.testing.assert_array_equal(np.isfinite(got[0]), valid)
        np.testing.assert_array_equal(got[1][valid], want[1][valid])
        np.testing.assert_allclose(got[0][valid], want[0][valid], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got[2][valid], want[2][valid])
    got = tdev.topk_unseen_scorer(
        modalities.fused_scorer(w, cand), inter.n_users, cand.size,
        inter.seen_bitmap, cand, 5, want_rr=False, device="cpu")
    assert got[2] is None


@pytest.mark.parametrize("n_items,n_cand", [(60, 60), (70, 37), (33, 1)])
def test_candidate_words_equal_the_host_pack(n_items, n_cand):
    """The device re-pack of the seen bitmap equals the host's
    pack_candidate_bitmap, bit 31 and ragged word counts included, in
    chunks of users."""
    rng = np.random.default_rng(n_items + n_cand)
    n_words = (n_items + 31) // 32
    seen = rng.integers(0, 2**32, size=(29, n_words), dtype=np.uint32)
    cand = rng.permutation(n_items)[:n_cand]
    want = pack_candidate_bitmap(seen, cand)
    got = tdev.candidate_words(seen, cand, device="cpu", user_chunk=8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    again = tdev.candidate_words(torch.from_numpy(seen.view(np.int32)),
                                 cand, device="cpu")
    np.testing.assert_array_equal(again.numpy(), got.numpy())
