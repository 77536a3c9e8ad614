"""The port's batched ALS core against the JAX package's: the block plan,
half-sweeps with and without a prior, and the batched solve.

Tolerances:
- plans are integer layouts built by the same NumPy steps: equal;
- a half-sweep: the port sums Σ v vᵀ over the pairs (a CSR product) where
  JAX multiplies a dense 0/1 selection matrix, and factors with LAPACK
  where JAX runs its own loop, so the fp32 sums differ in order: rtol 1e-4,
  atol 1e-5 (the inputs are N(0, 1));
- the dense NumPy oracle of ``tests/test_als.py`` (float64, no jitter):
  its tolerance there, rtol 2e-3 / atol 2e-4;
- the batched solve on well-conditioned SPD systems: rtol 1e-4; on a
  rank-1-dominant system with cond ~1e5 fp32 loses about cond·eps ≈ 1e-2
  relative, so both packages are held to the float64 solve of the same
  jittered system within 2e-2 (norm-wise) and the port must be finite;
- a system that fp32 Cholesky cannot factor (a negative pivot): the port
  re-solves it with the transcription of JAX's looped Cholesky and its
  pivot floor, so it equals JAX's result (rtol 1e-4) where a bare
  ``cholesky_ex`` + ``cholesky_solve`` gives NaN or a wrong answer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topk_rec_tpu.ops import als as jals
from topk_rec_torch.ops import als as tals

SWEEP_TOL = dict(rtol=1e-4, atol=1e-5)


def _oracle(this_emb, other_emb, indptr, flat, rated_other, a, b, lam,
            prior=None):
    """tests/test_als.py:9-27: per-entity float64 solves."""
    out = this_emb.astype(np.float64).copy()
    k = this_emb.shape[1]
    Vr = other_emb[rated_other].astype(np.float64)
    XX = b * (Vr.T @ Vr) + lam * np.eye(k)
    for t in range(this_emb.shape[0]):
        cols = flat[indptr[t]:indptr[t + 1]]
        if len(cols) == 0 and prior is None:
            continue
        Vi = other_emb[cols].astype(np.float64)
        A = XX + (a - b) * (Vi.T @ Vi)
        rhs = a * Vi.sum(0) if len(cols) else np.zeros(k)
        if prior is not None:
            rhs = rhs + lam * prior[t]
        out[t] = np.linalg.solve(A, rhs)
    return out


@pytest.mark.parametrize("block_size", [16, 64])
@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("balanced", [True, False])
def test_plan_equals_jax(small_inter, side, balanced, block_size):
    indptr, flat = getattr(small_inter, f"{side}_csr")
    n = small_inter.n_users if side == "user" else small_inter.n_items
    want = jals.ALSPlan(indptr, flat, n, block_size=block_size,
                        balanced=balanced)
    got = tals.ALSPlan(indptr, flat, n, block_size=block_size,
                       balanced=balanced, device="cpu")
    assert got.n_blocks == want.n_blocks > 1
    assert got.cap == want.cap
    for name in ("rows_stack", "cols_stack", "deg_stack", "perm"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_selection_holds_the_plan_pairs(small_inter):
    """Row s of block b's CSR matrix counts slot s's pairs; the extra last
    row takes exactly the padding pairs."""
    indptr, flat = small_inter.user_csr
    plan = tals.ALSPlan(indptr, flat, small_inter.n_users, block_size=64,
                        device="cpu")
    n_other = small_inter.n_items
    for blk, S in enumerate(plan.selection_for(n_other)):
        dense = np.zeros((plan.block_size + 1, n_other))
        np.add.at(dense, (plan.rows_stack[blk].numpy(),
                          plan.cols_stack[blk].numpy()), 1.0)
        np.testing.assert_array_equal(S.to_dense().numpy(), dense)


@pytest.mark.parametrize("with_prior", [False, True])
@pytest.mark.parametrize("keep_old", [True, False])
@pytest.mark.parametrize("side", ["user", "item"])
def test_half_sweep_equals_jax(small_inter, with_prior, keep_old, side):
    rng = np.random.default_rng(3)
    k = 6
    n_u, n_i = small_inter.n_users, small_inter.n_items
    if side == "user":
        n_this, (indptr, flat) = n_u, small_inter.user_csr
        n_other, rated = n_i, small_inter.rated_items
    else:
        n_this, (indptr, flat) = n_i, small_inter.item_csr
        n_other, rated = n_u, small_inter.rated_users
    this = rng.normal(size=(n_this, k)).astype(np.float32)
    other = rng.normal(size=(n_other, k)).astype(np.float32)
    prior = (rng.normal(size=(n_this, k)).astype(np.float32)
             if with_prior else None)
    a, b, lam = 1.0, 0.01, 0.5
    jp = jals.ALSPlan(indptr, flat, n_this, block_size=64)
    want, want_fit = jals.half_sweep(jp, this, other, jnp.asarray(rated), a,
                                     b, lam, prior=prior,
                                     keep_old_unrated=keep_old)
    tp = tals.ALSPlan(indptr, flat, n_this, block_size=64, device="cpu")
    got, got_fit = tals.half_sweep(tp, this, other, rated, a, b, lam,
                                   prior=prior, keep_old_unrated=keep_old)
    np.testing.assert_allclose(got, want, **SWEEP_TOL)
    np.testing.assert_allclose(got_fit, want_fit, rtol=1e-4)
    oracle = _oracle(this, other, indptr, flat, rated, a, b, lam, prior)
    if not keep_old and prior is None:  # unrated rows solve to zero
        oracle[np.diff(indptr) == 0] = 0.0
    np.testing.assert_allclose(got, oracle, rtol=2e-3, atol=2e-4)


def test_half_sweep_device_resident(small_inter):
    """``as_numpy=False`` returns tensors equal to the host path's."""
    rng = np.random.default_rng(4)
    U = rng.normal(size=(small_inter.n_users, 4)).astype(np.float32)
    V = rng.normal(size=(small_inter.n_items, 4)).astype(np.float32)
    plan = tals.ALSPlan(*small_inter.user_csr, small_inter.n_users,
                        block_size=16, device="cpu")
    want, want_fit = tals.half_sweep(plan, U, V, small_inter.rated_items,
                                     1.0, 0.01, 0.05)
    got, got_fit = tals.half_sweep(plan, torch.from_numpy(U),
                                   torch.from_numpy(V),
                                   small_inter.rated_items, 1.0, 0.01, 0.05,
                                   as_numpy=False)
    assert isinstance(got, torch.Tensor) and got_fit.dim() == 0
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got_fit) == want_fit


def test_weighted_als_user_update_equals_jax(small_inter, tiny_inter):
    rng = np.random.default_rng(5)
    for inter, bs in ((small_inter, 32), (tiny_inter, 2048)):
        U = rng.normal(size=(inter.n_users, 5)).astype(np.float32)
        V = rng.normal(size=(inter.n_items, 5)).astype(np.float32)
        want = jals.weighted_als_user_update(U, V, inter, 1.0, 0.01, 0.1,
                                             block_size=bs)
        got = tals.weighted_als_user_update(U, V, inter, 1.0, 0.01, 0.1,
                                            block_size=bs, device="cpu")
        np.testing.assert_allclose(got, want, **SWEEP_TOL)
    # tiny_inter's user 3 has no positives: its row is kept
    np.testing.assert_array_equal(got[3], U[3])


@pytest.mark.parametrize("entry", ["ALSPlan", "weighted_als_user_update"])
def test_entry_points_default_to_the_card(small_inter, monkeypatch, entry):
    """Called without a device, the plan and the one-shot update ask for
    CUDA, as every entry point of the port does: here, with no card, that
    is an error that names the CPU option, never a silent run on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    U = np.zeros((small_inter.n_users, 3), np.float32)
    V = np.zeros((small_inter.n_items, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "ALSPlan":
            tals.ALSPlan(*small_inter.user_csr, small_inter.n_users)
        else:
            tals.weighted_als_user_update(U, V, small_inter, 1.0, 0.01, 0.1)


def test_gram_matrix_equals_jax():
    E = np.random.default_rng(6).normal(size=(40, 7)).astype(np.float32)
    rows = np.array([0, 3, 5, 39])
    np.testing.assert_allclose(
        tals.gram_matrix(torch.from_numpy(E), torch.from_numpy(rows)).numpy(),
        np.asarray(jals.gram_matrix(jnp.asarray(E), jnp.asarray(rows))),
        rtol=1e-5, atol=1e-5)


def _spd(rng, n, k, collinear=None):
    if collinear is None:
        X = rng.normal(size=(n, 2 * k, k))
    else:  # rows of X close to one direction per system
        c = rng.normal(size=(n, 1, k))
        X = c + collinear * rng.normal(size=(n, 2 * k, k))
    return np.einsum("nrk,nrl->nkl", X, X).astype(np.float32)


def test_batched_solve_spd_equals_jax():
    rng = np.random.default_rng(7)
    A = _spd(rng, 32, 12) + 0.5 * np.eye(12, dtype=np.float32)
    rhs = rng.normal(size=(32, 12)).astype(np.float32)
    want = np.asarray(jals.batched_solve(jnp.asarray(A), jnp.asarray(rhs)))
    got = tals.batched_solve(torch.from_numpy(A), torch.from_numpy(rhs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    multi = rng.normal(size=(32, 12, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tals.batched_solve(torch.from_numpy(A), torch.from_numpy(multi)),
        np.asarray(jals.batched_solve(jnp.asarray(A), jnp.asarray(multi))),
        rtol=1e-4, atol=1e-6)


def test_batched_solve_rank1_dominant_is_finite():
    """Nearly collinear fixed-side vectors (an untrained encoder's outputs
    in DPM, als.py:60-63): cond ~1e5."""
    rng = np.random.default_rng(8)
    k = 20
    A = _spd(rng, 16, k, collinear=2e-2)
    rhs = rng.normal(size=(16, k)).astype(np.float32)
    Aj = tals._jitter(torch.from_numpy(A).double())[0].numpy()
    cond = np.linalg.cond(Aj)
    assert 1e4 < np.median(cond) < 1e6, np.median(cond)
    exact = np.linalg.solve(Aj, rhs[..., None].astype(np.float64))[..., 0]
    got = tals.batched_solve(torch.from_numpy(A), torch.from_numpy(rhs))
    want = np.asarray(jals.batched_solve(jnp.asarray(A), jnp.asarray(rhs)))
    assert np.isfinite(got.numpy()).all()
    for x in (got.numpy(), want):
        err = np.linalg.norm(x - exact, axis=1) / np.linalg.norm(exact,
                                                                 axis=1)
        assert err.max() < 2e-2, err.max()


def test_batched_solve_falls_back_where_cholesky_fails():
    """A system whose fp32 factorization meets a negative pivot: JAX clamps
    the pivot to 1e-10·trace/k and stays finite; the port's cholesky_ex
    reports the failure, its partial factor solves to NaN or to a wrong
    answer, and the looped fallback gives JAX's answer."""
    rng = np.random.default_rng(9)
    k = 8
    good = _spd(rng, 3, k) + np.eye(k, dtype=np.float32)
    c = rng.normal(size=k).astype(np.float32)
    bad = 100.0 * np.outer(c, c) + np.eye(k, dtype=np.float32)
    bad[-1, -1] -= 1.0 + 100.0 * c[-1] ** 2 + 0.5  # indefinite by 0.5
    A = np.concatenate([good, bad[None]]).astype(np.float32)
    rhs = rng.normal(size=(4, k)).astype(np.float32)
    At, rt = torch.from_numpy(A), torch.from_numpy(rhs)
    L, info = torch.linalg.cholesky_ex(tals._jitter(At)[0])
    assert info.tolist()[:3] == [0, 0, 0] and info[3] > 0
    want = np.asarray(jals.batched_solve(jnp.asarray(A), jnp.asarray(rhs)))
    # the failed factor is partial: NaN or a wrong answer, never JAX's
    bare = torch.cholesky_solve(rt[..., None], L)[..., 0].numpy()
    assert not np.allclose(bare[3], want[3], rtol=1e-2)
    got = tals.batched_solve(At, rt).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    # the transcription is JAX's loop on every system
    np.testing.assert_allclose(tals.looped_cholesky_solve(At, rt).numpy(),
                               want, rtol=1e-4, atol=1e-6)
