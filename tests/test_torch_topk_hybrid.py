"""The port's hybrid top-k and threshold count (plain twins on the CPU)
against the JAX package's ``ops/topk_hybrid.py``, on the fixture of
tests/test_topk_hybrid.py rebuilt with numpy.

Tolerances: none. The fixture's quantized rows make exact ties, and its
scores are bit-equal between numpy's and torch's float32 matmuls (checked
below), so counts must be equal and the hybrid must equal ``lax.top_k``
bit for bit. JAX's ``approx_max_k`` is exact on the CPU; the port's
selector really is approximate, so it is held to XLA's bin counts,
validity and recall, not to JAX's output.
"""

import itertools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax._src.lib import _jax

from topk_rec_tpu.ops import topk_hybrid as jh
from topk_rec_torch.ops import topk_hybrid as th
from topk_rec_torch.ops.topk_fused import NEG_INF, masked_scores, pack_mask

K = 30


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    """tests/test_topk_hybrid.py:18-32; row 7 also gets only 5 unseen."""
    rng = np.random.default_rng(0)
    n_u, n_i, d = 300, 500, 20
    U = rng.normal(size=(n_u, d)).astype(np.float32)
    V = rng.normal(size=(n_i, d)).astype(np.float32)
    b = rng.normal(size=n_i).astype(np.float32)
    mask = (rng.random((n_u, n_i)) < 0.05).astype(np.int8)
    U[:50] = np.round(U[:50])
    V[:100] = np.round(V[:100])
    b = np.round(b)
    few = mask.copy()
    few[7, :] = 1
    few[7, :5] = 0
    return U, V, b, mask, few


def _scores(U, V, b, mask):
    s = U @ V.T + b[None, :]
    return np.where(mask != 0, NEG_INF, s).astype(np.float32)


def _torch(U, V, b, mask):
    return (torch.from_numpy(U), torch.from_numpy(V),
            None if b is None else torch.from_numpy(b),
            pack_mask(torch.from_numpy(mask)))


def _np_counts(s, t):
    """The definition, in numpy float32 over the real items."""
    tc = t[:, None]
    eps = np.float32(1e-4) * np.maximum(np.abs(tc), np.abs(s)) + \
        np.float32(1e-6)
    return ((s > tc + eps).sum(1), (np.abs(s - tc) <= eps).sum(1))


def test_fixture_scores_bit_equal(problem):
    U, V, b, mask, _ = problem
    got = masked_scores(*_torch(U, V, b, mask), exact_matmul=True).numpy()
    np.testing.assert_array_equal(got, _scores(U, V, b, mask))


@pytest.mark.parametrize("exact", [True, False])
def test_counts_match_jax_interpret(problem, exact):
    """count_vs_threshold_plain vs JAX's _count_vs_threshold (Pallas
    interpret mode) on inputs padded as topk_hybrid.py:269-281 pads them.
    JAX pads the catalog with masked columns, which it counts in eq when
    t is NEG_INF: the rows compared are those with a finite t. JAX's
    DEFAULT precision is full fp32 on the CPU, so the bf16 mode feeds JAX
    the bf16-rounded tables."""
    U, V, b, _, few = problem
    Uj, Vj = (U, V) if exact else (_bf16(U), _bf16(V))
    t = np.asarray(jax.lax.top_k(_scores(Uj, Vj, b, few), K)[0])[:, K - 1]
    gt, eq = th.count_vs_threshold(*_torch(U, V, b, few),
                                   torch.from_numpy(t.copy()), exact)
    bu, bi = 128, 256
    pu, pi, pd = (-U.shape[0]) % bu, (-V.shape[0]) % bi, (-U.shape[1]) % 128
    jg, je = jh._count_vs_threshold(
        jnp.pad(jnp.asarray(Uj), ((0, pu), (0, pd))),
        jnp.pad(jnp.asarray(Vj), ((0, pi), (0, pd))),
        jnp.pad(jnp.asarray(b), (0, pi)).reshape(1, -1),
        jnp.pad(jnp.asarray(few), ((0, pu), (0, pi)), constant_values=1),
        jnp.pad(jnp.asarray(t), (0, pu)), bu, bi, True, True,
    )
    n_u = U.shape[0]
    jg, je = np.asarray(jg)[:n_u], np.asarray(je)[:n_u]
    fin = t > NEG_INF
    assert (~fin).sum() == 1 and not fin[7]
    np.testing.assert_array_equal(gt.numpy()[fin], jg[fin])
    np.testing.assert_array_equal(eq.numpy()[fin], je[fin])
    # row 7: the port counts the 495 excluded real items; JAX adds its
    # 12 padding columns
    assert (gt[7].item(), eq[7].item()) == (5, 495)
    assert (jg[7], je[7]) == (5, 495 + pi)


@pytest.mark.parametrize("with_bias", [True, False])
def test_counts_match_definition(problem, with_bias):
    """All rows, the NEG_INF row included, against numpy float32; t from
    the exact top-k (ties at the threshold) and from arbitrary values."""
    U, V, b, _, few = problem
    b = b if with_bias else None
    s = _scores(U, V, np.zeros(V.shape[0], np.float32) if b is None else b,
                few)
    t_top = np.asarray(jax.lax.top_k(s, K)[0])[:, K - 1]
    t_any = np.random.default_rng(1).normal(size=U.shape[0]).astype(
        np.float32) * 4
    for t in (t_top, t_any):
        gt, eq = th.count_vs_threshold(*_torch(U, V, b, few),
                                       torch.from_numpy(t.copy()))
        wg, we = _np_counts(s, t)
        np.testing.assert_array_equal(gt.numpy(), wg)
        np.testing.assert_array_equal(eq.numpy(), we)
    assert gt.dtype == torch.int32 and eq.dtype == torch.int32


@pytest.mark.parametrize(
    "k_extra,cap,recall", [(20, 64, 0.95), (2, 32, 0.8), (0, 128, 0.9)]
)
@pytest.mark.parametrize("few_unseen", [False, True])
def test_hybrid_bit_equal(problem, k_extra, cap, recall, few_unseen):
    """Bit-equal to lax.top_k and to JAX's exact_topk_hybrid; empty slots
    hold (NEG_INF, -1) where JAX keeps a masked item."""
    U, V, b, mask, few = problem
    m = few if few_unseen else mask
    ev, ei = (np.asarray(x) for x in jax.lax.top_k(_scores(U, V, b, m), K))
    hv, hi, n_bad = th.exact_topk_hybrid(
        *_torch(U, V, b, m), K, k_extra=k_extra, cap=cap, recall=recall,
        with_stats=True,
    )
    jv, ji = jh.exact_topk_hybrid(
        jnp.asarray(U), jnp.asarray(V), jnp.asarray(b), jnp.asarray(m), K,
        k_extra=k_extra, cap=cap, recall=recall, block_u=128, block_i=256,
    )
    hv, hi = hv.numpy(), hi.numpy()
    assert hi.dtype == np.int32
    np.testing.assert_array_equal(hv, ev)
    np.testing.assert_array_equal(hv, np.asarray(jv))
    live = ev > NEG_INF
    assert (~live).sum() == (25 if few_unseen else 0)
    np.testing.assert_array_equal(hi[live], ei[live])
    np.testing.assert_array_equal(hi[live], np.asarray(ji)[live])
    assert (hi[~live] == -1).all()
    assert isinstance(n_bad, int) and 0 < n_bad <= U.shape[0]
    if few_unseen:
        assert n_bad >= 1  # row 7 always fails the audit
    if recall == 0.8:
        # 256 bins of 2 items: the selector really misses (JAX-on-CPU's
        # approx_max_k is exact and repairs only the tied rows)
        assert n_bad > 100


def test_hybrid_serving_mode_equals_rounded_exact(problem):
    """exact_matmul=False on fp32 tables == exact mode on the bf16-rounded
    tables, and both equal lax.top_k of those scores."""
    U, V, b, mask, _ = problem
    v1, i1 = th.exact_topk_hybrid(*_torch(U, V, b, mask), K,
                                  exact_matmul=False)
    v2, i2 = th.exact_topk_hybrid(*_torch(_bf16(U), _bf16(V), b, mask), K)
    assert torch.equal(v1, v2) and torch.equal(i1, i2)
    ev, ei = jax.lax.top_k(_scores(_bf16(U), _bf16(V), b, mask), K)
    np.testing.assert_array_equal(v1.numpy(), np.asarray(ev))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ei))


def test_hybrid_k_past_catalog_and_no_bias():
    """k > n_items pads with (NEG_INF, -1), as fused_score_topk does."""
    rng = np.random.default_rng(3)
    U = rng.normal(size=(6, 4)).astype(np.float32)
    V = rng.normal(size=(9, 4)).astype(np.float32)
    mask = np.zeros((6, 9), np.int8)
    mask[2, :4] = 1
    args = _torch(U, V, None, mask)
    v, i = th.exact_topk_hybrid(*args, 12)
    ev, ei = jax.lax.top_k(masked_scores(*args, exact_matmul=True).numpy(), 9)
    live = np.asarray(ev) > NEG_INF
    np.testing.assert_array_equal(v.numpy()[:, :9], np.asarray(ev))
    np.testing.assert_array_equal(i.numpy()[:, :9][live],
                                  np.asarray(ei)[live])
    assert (v.numpy()[:, 9:] == NEG_INF).all()
    assert (i.numpy()[:, 9:] == -1).all()
    assert (i.numpy()[2, 5:] == -1).all()


XLA_TABLE = [  # (n, k, recall) -> (bins, log2 of the reduction)
    (10380, 30, 0.95), (10380, 50, 0.95), (10380, 30, 0.8),
    (10380, 50, 0.9), (10380, 128, 0.95), (500, 30, 0.8), (500, 30, 0.9),
    (2000, 8, 0.8),
]


def test_approx_bins_match_xla():
    grid = itertools.product(
        [1, 50, 128, 129, 200, 257, 300, 500, 2000, 10380, 100000],
        [1, 2, 8, 30, 50, 128], [0.3, 0.5, 0.8, 0.9, 0.95, 0.99, 1.0],
    )
    cases = XLA_TABLE + [(n, k, r) for n, k, r in grid if k <= n]
    for n, k, r in cases:
        want = tuple(_jax.approx_top_k_reduction_output_size(
            n, 2, k, r, False, -1))
        assert th.approx_bins(n, k, r) == want, (n, k, r)
    assert th.approx_bins(10380, 30, 0.95) == (768, 4)
    with pytest.raises(ValueError, match="recall"):
        th.approx_bins(500, 30, 0.0)


@pytest.mark.parametrize("n,k", [(10380, 30), (2000, 8), (500, 50)])
def test_approx_topk_valid_with_recall(n, k):
    """True scores, descending, no excluded item, recall >= 0.9 at the
    default recall target 0.95; exact where XLA does not reduce."""
    rng = np.random.default_rng(n + k)
    rows = 64
    s = rng.normal(size=(rows, n)).astype(np.float32)
    s[rng.random((rows, n)) < 0.1] = -np.inf  # excluded items
    st = torch.from_numpy(s)
    v, i = th.approx_topk(st, k)
    assert v.shape == i.shape == (rows, k)
    np.testing.assert_array_equal(v.numpy(),
                                  np.take_along_axis(s, i.numpy(), 1))
    assert np.isfinite(v.numpy()).all()
    assert (np.diff(v.numpy(), axis=1) <= 0).all()
    want = np.argsort(-s, axis=1, kind="stable")[:, :k]
    recall = np.mean([len(set(a) & set(b)) / k
                      for a, b in zip(i.numpy(), want)])
    assert recall >= 0.9
    # 500 x 50 is not reduced (exact); the reduced rows lose some items
    # to bins they share
    assert (recall < 1.0) == (th.approx_bins(n, k, 0.95)[1] > 0)


def test_approx_topk_unreduced_rows_are_exact():
    """Rows of at most 128 items (and a recall of 1) are not reduced: the
    result is the exact top-k in lax.top_k order, ties included."""
    s = np.round(np.random.default_rng(5).normal(size=(10, 100)), 1)
    s = s.astype(np.float32)
    v, i = th.approx_topk(torch.from_numpy(s), 7)
    ev, ei = jax.lax.top_k(s, 7)
    np.testing.assert_array_equal(v.numpy(), np.asarray(ev))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ei))
    s2 = np.random.default_rng(6).normal(size=(4, 3000)).astype(np.float32)
    v, i = th.approx_topk(torch.from_numpy(s2), 5, recall=1.0)
    np.testing.assert_array_equal(i.numpy(),
                                  np.asarray(jax.lax.top_k(s2, 5)[1]))


def test_count_wrapper_rejects_bad_inputs():
    U, V = torch.zeros(4, 3), torch.zeros(40, 3)
    words = torch.zeros(4, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="t must be"):
        th.count_vs_threshold(U, V, None, words, torch.zeros(3))
    with pytest.raises(ValueError, match="t must be"):
        th.count_vs_threshold(U, V, None, words,
                              torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="excl_bits"):
        th.count_vs_threshold(U, V, None, words[:, :1], torch.zeros(4))
    with pytest.raises(ValueError, match="unsupported device"):
        th.count_vs_threshold(U.to("meta"), V.to("meta"), None,
                              words.to("meta"), torch.zeros(4).to("meta"))
    with pytest.raises(ValueError, match="k >= 1"):
        th.exact_topk_hybrid(U, V, None, words, 0)
