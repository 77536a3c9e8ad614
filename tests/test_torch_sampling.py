"""The port's triplet sampler, held to the checks of tests/test_sampling.py
and to the JAX sampler's distributions.

The port draws from a ``torch.Generator`` and JAX from threefry, so no
triplet can be compared one for one across the packages. The checks below
hold validity exactly and uniformity by counts, as the JAX tests do; the
cross-package test compares the two samplers' histograms with a
two-sample chi-square statistic, bounded at its degrees of freedom plus
six standard deviations (fixed seeds, so the test is deterministic).
"""

import jax
import numpy as np
import pytest
import torch

from topk_rec_tpu.ops.sampling import TripletSampler as JaxSampler
from topk_rec_torch.data import Interactions as PortInteractions
from topk_rec_torch.ops.sampling import TripletSampler


def _port(inter):
    """The port's own Interactions over the same arrays as ``inter``."""
    return PortInteractions(inter.n_users, inter.n_items, inter.pos_u,
                            inter.pos_i, inter.seen_u, inter.seen_i)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _check_valid(inter, u, i, j):
    pos = set(zip(inter.pos_u.tolist(), inter.pos_i.tolist()))
    rated = set(inter.rated_users.tolist())
    for uu, ii, jj in zip(u.tolist(), i.tolist(), j.tolist()):
        assert uu in rated
        assert (uu, ii) in pos, "i must be a positive of u"
        assert (uu, jj) not in pos, "j must not be a positive of u"
        assert 0 <= jj < inter.n_items


@pytest.mark.parametrize("membership", ["bitmap", "sorted"])
def test_triplets_valid(small_inter, membership):
    sampler = TripletSampler(_port(small_inter), membership=membership,
                             device="cpu")
    assert sampler.membership == membership
    u, i, j = sampler.sample_numpy(_gen(0), 4096)
    assert u.dtype == i.dtype == j.dtype == np.int64
    _check_valid(small_inter, u, i, j)


def test_user_uniformity(small_inter):
    sampler = TripletSampler(_port(small_inter), device="cpu")
    u, _, _ = sampler.sample_numpy(_gen(1), 60000)
    counts = np.bincount(u, minlength=small_inter.n_users)
    rated = small_inter.rated_users
    expected = 60000 / len(rated)
    assert counts[rated].min() > 0.6 * expected
    assert counts[rated].max() < 1.5 * expected
    unrated = np.setdiff1d(np.arange(small_inter.n_users), rated)
    assert counts[unrated].sum() == 0


def test_positive_uniform_within_user(small_inter):
    sampler = TripletSampler(_port(small_inter), device="cpu")
    u, i, _ = sampler.sample_numpy(_gen(2), 120000)
    target = int(np.argmax(small_inter.user_deg))
    indptr, flat = small_inter.user_csr
    positives = flat[indptr[target]:indptr[target + 1]]
    counts = np.bincount(i[u == target], minlength=small_inter.n_items)
    counts = counts[positives]
    assert counts.min() > 0
    assert counts.max() < 3.5 * max(1, counts.mean())


def test_negative_distribution(small_inter):
    """Kept negatives are about uniform over each user's non-positives."""
    sampler = TripletSampler(_port(small_inter), device="cpu")
    u, _, j = sampler.sample_numpy(_gen(3), 120000)
    target = int(np.argmax(small_inter.user_deg))
    indptr, flat = small_inter.user_csr
    positives = set(flat[indptr[target]:indptr[target + 1]].tolist())
    negs = [x for x in range(small_inter.n_items) if x not in positives]
    counts = np.bincount(j[u == target], minlength=small_inter.n_items)
    assert counts[list(positives)].sum() == 0
    neg_counts = counts[negs]
    assert neg_counts.min() > 0
    assert neg_counts.max() < 4.0 * max(1.0, neg_counts.mean())


def test_determinism(small_inter):
    a = TripletSampler(_port(small_inter),
                       device="cpu").sample_numpy(_gen(7), 256)
    b = TripletSampler(_port(small_inter),
                       device="cpu").sample_numpy(_gen(7), 256)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_sorted_membership_identical_to_bitmap(small_inter):
    """Both stores consume one generator identically: the same seed gives
    byte-identical triplets."""
    bm = TripletSampler(_port(small_inter), membership="bitmap",
                        device="cpu")
    so = TripletSampler(_port(small_inter), membership="sorted",
                        device="cpu")
    for seed in (0, 3, 11):
        a = bm.sample_numpy(_gen(seed), 4096)
        b = so.sample_numpy(_gen(seed), 4096)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_membership_auto_selection(small_inter):
    """auto takes the bitmap under the budget and the sorted keys above."""
    sampler = TripletSampler(_port(small_inter), device="cpu")
    assert sampler.membership == "bitmap"
    tiny = TripletSampler(_port(small_inter), membership="auto",
                          bitmap_budget_bytes=1, device="cpu")
    assert tiny.membership == "sorted"
    u, i, j = tiny.sample_numpy(_gen(9), 512)
    assert len(u) == 512
    _check_valid(small_inter, u, i, j)
    with pytest.raises(ValueError, match="membership"):
        TripletSampler(_port(small_inter), membership="dense",
                       device="cpu")


def test_bpr_training_identical_across_membership(small_inter):
    """BPR with the sorted store yields exactly the bitmap store's tables
    (same seed -> same triplets -> same trajectory, on the CPU)."""
    from topk_rec_torch.models import BPR

    out = {}
    for membership in ("bitmap", "sorted"):
        m = BPR(k=8, seed=3, membership=membership, device="cpu")
        m.set_interactions(_port(small_inter))
        m.train(epochs=1, batch_size=64, epoch_sample_limit=640,
                scan_steps=10, verbose=False)
        out[membership] = (m.fue.copy(), m.fie.copy(), m.fib.copy())
    for a, b in zip(out["bitmap"], out["sorted"]):
        np.testing.assert_array_equal(a, b)


def test_single_negative_user_both_stores():
    """A user whose positives cover every item but one: each of its
    negatives is that item, through both stores (the redraw loop)."""
    n_items = 40
    # user 0 likes everything but item 17; user 1 likes item 3 only
    pos_u = np.array([0] * (n_items - 1) + [1], np.int32)
    pos_i = np.array([i for i in range(n_items) if i != 17] + [3], np.int32)
    inter = PortInteractions(2, n_items, pos_u, pos_i)
    for membership in ("bitmap", "sorted"):
        s = TripletSampler(inter, membership=membership, device="cpu")
        u, i, j = s.sample_numpy(_gen(1), 512)
        assert np.all(j[u == 0] == 17), membership
        assert np.all(j[u == 1] != 3), membership
        assert (u == 0).sum() > 100


def test_sampler_defaults_to_the_card(small_inter, monkeypatch):
    """Built without a device, the sampler asks for CUDA, as every entry
    point of the port does: here, with no card, that is an error that
    names the CPU option, never a silent run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TripletSampler(_port(small_inter))


def _chi2_two_sample(a, b):
    """Two-sample chi-square statistic and its degrees of freedom over the
    bins that either sample hit (equal sample sizes)."""
    keep = (a + b) > 0
    a, b = a[keep].astype(float), b[keep].astype(float)
    return float(((a - b) ** 2 / (a + b)).sum()), int(keep.sum()) - 1


def test_same_distribution_as_jax_sampler(small_inter):
    """Users, the top user's positives and negatives: the port's counts
    and the JAX sampler's agree within df + 6·sqrt(2·df) of a two-sample
    chi-square."""
    n = 120000
    tu, ti, tj = TripletSampler(_port(small_inter),
                                device="cpu").sample_numpy(_gen(5), n)
    ju, ji, jj = JaxSampler(small_inter).sample_numpy(
        jax.random.PRNGKey(5), n)
    target = int(np.argmax(small_inter.user_deg))
    m = small_inter.n_items
    pairs = [
        (np.bincount(tu, minlength=small_inter.n_users),
         np.bincount(ju, minlength=small_inter.n_users)),
        (np.bincount(ti[tu == target], minlength=m),
         np.bincount(ji[ju == target], minlength=m)),
        (np.bincount(tj[tu == target], minlength=m),
         np.bincount(jj[ju == target], minlength=m)),
    ]
    for a, b in pairs:
        # rescale the second sample to the first's size before comparing
        b = np.round(b * a.sum() / b.sum()).astype(np.int64)
        stat, df = _chi2_two_sample(a, b)
        assert stat < df + 6 * np.sqrt(2 * df), (stat, df)
