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


def _count_hits_per_like(top_idx, top_vals, seen_above, likes, n_cand, step,
                         total):
    """The hit count with the like bitmap built one like at a time, as the
    port built it before its array build: the reference for that build."""
    interval = total // step
    users = np.array([u for u, l in likes.items() if len(l) > 0],
                     dtype=np.int64)
    count = sum(len(l) for l in likes.values())
    if users.size == 0:
        return tdev.EvalResult(hits=np.zeros(interval),
                               rr=np.zeros(interval), count=count)
    like_bm = np.zeros((users.size, (n_cand + 31) // 32), dtype=np.uint32)
    for row, u in enumerate(users):
        for c in likes[int(u)]:
            like_bm[row, c >> 5] |= np.uint32(1) << np.uint32(c & 31)
    idx = top_idx[users]
    valid = np.isfinite(top_vals[users])
    words = like_bm[np.arange(users.size)[:, None], idx >> 5]
    hit = ((words >> (idx & 31).astype(np.uint32)) & 1).astype(bool) & valid
    k_eff = idx.shape[1]
    hits = np.zeros(interval)
    for j in range(interval):
        hits[j] = hit[:, :min((j + 1) * step, k_eff)].sum()
    rrs = np.zeros(interval)
    if seen_above is not None:
        raw = np.arange(k_eff)[None, :] + seen_above[users]
        rr_vals = np.where(hit, 1.0 / (raw + 1.0), 0.0)
        bucket = raw // step
        for j in range(interval):
            rrs[j] = rr_vals[bucket <= j].sum()
    return tdev.EvalResult(hits=hits, rr=rrs, count=count)


def _hits_case(n_cand, n_users=14, k=12):
    """Top-k lists and likes that reach each corner of the like bitmap:
    bits 0, 31, 32 and n_cand - 1 returned and liked (user 0), a repeated
    like (user 1), an empty list (user 2), liked items in -inf slots (user
    3), a user with no entry (the last); the dict's order is not the
    users' order."""
    rng = np.random.default_rng(n_cand)
    top_idx = np.stack([rng.permutation(n_cand)[:k]
                        for _ in range(n_users)]).astype(np.int32)
    top_vals = -np.sort(-rng.normal(size=(n_users, k))).astype(np.float32)
    seen_above = np.cumsum(rng.integers(0, 3, (n_users, k)),
                           axis=1).astype(np.int32)
    corners = [0, 31, 32, n_cand - 1]
    top_idx[0, [0, 3, 7, 11]] = corners
    top_idx[1, :2] = [5, 40]
    top_vals[3, -4:] = -np.inf
    likes = {0: corners, 1: [5, 40, 5], 2: [],
             3: [int(c) for c in top_idx[3, -5:]]}
    for u in rng.permutation(np.arange(4, n_users - 1)):
        mine = rng.choice(top_idx[u], size=rng.integers(0, 4), replace=False)
        other = rng.choice(n_cand, size=rng.integers(1, 5), replace=False)
        likes[int(u)] = [int(c) for c in np.concatenate([mine, other])]
    return top_idx, top_vals, seen_above, likes


@pytest.mark.parametrize("with_rr", [True, False])
@pytest.mark.parametrize("container", [list, tuple, np.int64, np.int32])
@pytest.mark.parametrize("n_cand", [64, 97])
def test_count_hits_matches_per_like_reference_and_jax(n_cand, container,
                                                       with_rr):
    top_idx, top_vals, seen_above, likes = _hits_case(n_cand)
    if container in (list, tuple):
        likes = {u: container(l) for u, l in likes.items()}
    else:
        likes = {u: np.asarray(l, dtype=container) for u, l in likes.items()}
    sa = seen_above if with_rr else None
    step, total = 3, 12
    got = tdev._count_hits(top_idx, top_vals, sa, likes, n_cand, step, total)
    for ref in (_count_hits_per_like, jdev._count_hits):
        want = ref(top_idx, top_vals, sa, likes, n_cand, step, total)
        np.testing.assert_array_equal(got.hits, want.hits)
        np.testing.assert_array_equal(got.rr, want.rr)
        assert got.count == want.count
    # the case reaches what it is built for: every liked, returned, finite
    # slot is one hit, and every like counts, the repeated one too
    n_hit = sum(int(np.sum(np.isin(top_idx[u], list(l))
                           & np.isfinite(top_vals[u])))
                for u, l in likes.items())
    assert got.hits[-1] == n_hit and n_hit >= 4 + 2 + 1
    assert got.count == sum(len(l) for l in likes.values())
    assert (got.rr[-1] > 0) == with_rr
