"""The port's evaluator against the JAX package's and against the NumPy
oracle (topk_rec_tpu/eval/protocol.py, the specification).

Hits and counts must be EQUAL: they count returned items, so any
difference means a different item was returned. Reciprocal ranks are sums
of 1/(t+1) over the same integer ranks, equal to 1e-12 (see _assert_equal
for why not bit-equal). Inputs are continuous
random values, whose fp32 scores are tie-free far above the summation-order
noise between the packages (~1e-6).
"""

import numpy as np
import pytest

from topk_rec_tpu.eval import evaluate_oracle
from topk_rec_tpu.eval import device as jdev
from topk_rec_torch.eval import device as tdev

ENGINES = [False, True]  # use_kernel: torch engine, kernel (its CPU twin)


def _fold(seed, n_users=60, n_items=90, dim=8, n_cand=40, density=0.3):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, dim)).astype(np.float32)
    V = rng.normal(size=(n_items, dim)).astype(np.float32)
    bias = rng.normal(size=n_items).astype(np.float32)
    cand = rng.choice(n_items, size=n_cand, replace=False).astype(np.int64)
    seen_dense = rng.random((n_users, n_items)) < density
    seen_dense[1, cand[:-3]] = True  # user 1: only 3 unseen candidates
    n_words = (n_items + 31) // 32
    seen_bm = np.zeros((n_users, n_words), dtype=np.uint32)
    for u, i in zip(*np.nonzero(seen_dense)):
        seen_bm[u, i >> 5] |= np.uint32(1) << np.uint32(i & 31)
    likes = {}
    for u in range(0, n_users, 2):
        likes[u] = list(rng.choice(n_cand, size=rng.integers(1, 5),
                                   replace=False))
    likes[1] = [int(np.nonzero(~seen_dense[1, cand])[0][0])]
    likes[2] = []  # a user with an empty like list is skipped
    return U, V, bias, cand, seen_dense, seen_bm, likes


def _assert_equal(a, b):
    np.testing.assert_array_equal(a.hits, b.hits)
    # rr: the same nonzero terms, but the empty slots past a user's unseen
    # items carry another raw rank (index -1 vs a masked item), so the
    # boolean bucket selection sums a different count of zeros and numpy's
    # pairwise summation groups the terms differently: ~1e-16 relative
    np.testing.assert_allclose(a.rr, b.rr, rtol=1e-12)
    assert a.count == b.count


@pytest.mark.parametrize("use_kernel", ENGINES)
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("step,total", [(5, 30), (3, 9)])
def test_candidate_space_matches_oracle_and_jax(seed, step, total, use_kernel):
    U, V, bias, cand, seen_dense, seen_bm, likes = _fold(seed)
    V_cand, b_cand = V[cand], bias[cand]
    oracle = evaluate_oracle(
        U @ V_cand.T + b_cand[None, :], seen_dense[:, cand], likes,
        step=step, total=total,
    )
    jax_res = jdev.evaluate_scores_device(
        U, V_cand, b_cand, seen_bm, cand, likes, step=step, total=total,
        user_chunk=17,
    )
    port = tdev.evaluate_scores_device(
        U, V_cand, b_cand, seen_bm, cand, likes, step=step, total=total,
        user_chunk=17, use_kernel=use_kernel, device="cpu",
    )
    np.testing.assert_array_equal(port.hits, oracle.hits)
    assert port.count == oracle.count
    # the oracle sums 1/(t+1) per user in another order: 1e-12 relative
    np.testing.assert_allclose(port.rr, oracle.rr, rtol=1e-12)
    _assert_equal(port, jax_res)


@pytest.mark.parametrize("use_kernel", ENGINES)
@pytest.mark.parametrize("want_rr", [True, False])
def test_device_evaluator_full_space_matches_jax(use_kernel, want_rr):
    U, V, bias, cand, _, seen_bm, likes = _fold(11, n_users=70, n_cand=50)
    jax_ev = jdev.DeviceEvaluator(
        seen_bm, user_chunk=33, use_pallas=use_kernel, want_rr=want_rr
    )
    port_ev = tdev.DeviceEvaluator(
        seen_bm, user_chunk=33, use_kernel=use_kernel, want_rr=want_rr,
        device="cpu",
    )
    for b in (bias, None):
        _assert_equal(
            port_ev.evaluate(U, V, b, cand, likes),
            jax_ev.evaluate(U, V, b, cand, likes),
        )


def test_new_seen_bitmap_is_not_stale():
    """Assigning a new seen bitmap must re-ship it: the evaluator keys its
    device copy on the source array."""
    U, V, bias, cand, _, seen_bm, likes = _fold(5)
    ev = tdev.DeviceEvaluator(seen_bm, device="cpu")
    first = ev.evaluate(U, V, bias, cand, likes)
    empty = np.zeros_like(seen_bm)
    ev.seen_bitmap = empty
    second = ev.evaluate(U, V, bias, cand, likes)
    fresh = tdev.DeviceEvaluator(empty, device="cpu").evaluate(
        U, V, bias, cand, likes
    )
    _assert_equal(second, fresh)
    assert not np.array_equal(first.hits, second.hits)


@pytest.mark.parametrize("use_kernel", ENGINES)
def test_engines_agree_with_raw_rank(use_kernel):
    U, V, bias, cand, seen_dense, seen_bm, likes = _fold(3, n_cand=90)
    scores = U @ V[cand].T + bias[cand][None, :]
    oracle = evaluate_oracle(scores, seen_dense[:, cand], likes)
    got = tdev.evaluate_scores_device_full(
        U, V, bias, seen_bm, cand, likes, user_chunk=25,
        use_kernel=use_kernel, device="cpu",
    )
    np.testing.assert_array_equal(got.hits, oracle.hits)
    np.testing.assert_allclose(got.rr, oracle.rr, rtol=1e-12)
    assert got.count == oracle.count
