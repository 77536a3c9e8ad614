"""P1, the floor of K1: the port's plain version against a NumPy
transcription of the probe kernel's arithmetic.

The probe's kernel (``make_kernel`` in benchmarks/probe_topk_floor.py) is
a closure inside its ``main()``, which builds full-size TPU arrays first, so
no test can call it. ``_probe`` below transcribes its lines 52-77 instead:
the grid of (BU user rows x BI items) blocks, the masked scores, the
running max over the 128-wide column chunks, carried across the item grid
in ``acc``, and in variant B the depth-1 index ``g1``, which the probe
folds into the value as g·1e-12 and which is kept apart here.

Differences the port makes on purpose: it reads K1's packed int32 mask
words instead of the probe's int8 mask, and a residue with no unmasked item
gets index -1 (the probe leaves its lane number there).

Tolerance: the transcription sums in float64; the port sums fp32 products
in torch's order, so values agree to rtol 1e-5 / atol 1e-5 (scores of
magnitude ~10 at d = 16). Indices are compared where the residue's best
score leads its second by more than 1e-4, or exactly on planted ties.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from topk_rec_torch.ops import topk_floor as tfl
from topk_rec_torch.ops.topk_fused import pack_mask

NEG_INF = np.float32(np.finfo(np.float32).min)
CH = 128


def _probe(U, V, b, mask, depth1, BU=8, BI=256):
    """probe_topk_floor.py:43-97 in NumPy: returns (acc, g) where g is the
    item of each residue's max (variant B) or None."""
    n_u, n_i = U.shape[0], V.shape[0]
    pu, pi = (-n_u) % BU, (-n_i) % BI
    U_p = np.pad(U.astype(np.float64), ((0, pu), (0, 0)))
    V_p = np.pad(V.astype(np.float64), ((0, pi), (0, 0)))
    b_p = np.pad(b.astype(np.float64), (0, pi))
    m_p = np.pad(mask, ((0, pu), (0, pi)), constant_values=1)
    acc = np.full((n_u + pu, CH), NEG_INF, np.float64)
    g_acc = np.full((n_u + pu, CH), -1, np.int64)
    for i in range((n_u + pu) // BU):
        rows = slice(i * BU, (i + 1) * BU)
        for j in range((n_i + pi) // BI):
            cols = slice(j * BI, (j + 1) * BI)
            scores = U_p[rows] @ V_p[cols].T + b_p[cols]
            scores = np.where(m_p[rows, cols] != 0, NEG_INF, scores)
            lane = np.broadcast_to(np.arange(CH), (BU, CH))
            m1 = np.full((BU, CH), NEG_INF)
            g1 = lane.copy()
            for c in range(BI // CH):
                v = scores[:, c * CH:(c + 1) * CH]
                gv = j * BI + c * CH + lane
                gt = v > m1
                m1 = np.maximum(v, m1)
                g1 = np.where(gt, gv, g1)
            if depth1:
                # the probe folds g1 into the value; kept apart here
                take = m1 > acc[rows]
                g_acc[rows] = np.where(take, g1, g_acc[rows])
            acc[rows] = np.maximum(acc[rows], m1)
    return acc[:n_u], (g_acc[:n_u] if depth1 else None)


def _case(seed, n_u, n_i, d, bias=True, density=0.2):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_u, d)).astype(np.float32)
    V = rng.normal(size=(n_i, d)).astype(np.float32)
    b = (rng.normal(size=n_i) if bias else np.zeros(n_i)).astype(np.float32)
    mask = (rng.random((n_u, n_i)) < density).astype(np.int8)
    mask[0] = 1                 # row 0: every item masked
    mask[1, : n_i - 3] = 1      # row 1: only the last three items open
    return U, V, b, mask


def _run(U, V, b, mask, exact, with_index, bias=True):
    words = pack_mask(torch.from_numpy(mask))
    return tfl.topk_floor(torch.from_numpy(U), torch.from_numpy(V),
                          torch.from_numpy(b) if bias else None, words,
                          exact_matmul=exact, with_index=with_index)


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("exact", [True, False], ids=["fp32", "bf16"])
@pytest.mark.parametrize("depth1", [False, True], ids=["A", "B"])
@pytest.mark.parametrize("n_u,n_i,d,bias", [
    (37, 301, 13, True),    # ragged: n_i % 32 and n_i % 128 != 0
    (20, 1000, 16, False),  # no bias, several item blocks
    (9, 90, 8, True),       # fewer items than residues
])
def test_plain_equals_probe_transcription(n_u, n_i, d, bias, exact, depth1):
    U, V, b, mask = _case(n_u + n_i, n_u, n_i, d, bias)
    got_v, got_i = _run(U, V, b, mask, exact, depth1, bias)
    # bf16 mode rounds the inputs; hand the transcription the same numbers
    Ur, Vr = (U, V) if exact else (_bf16(U), _bf16(V))
    want_v, want_g = _probe(Ur, Vr, b, mask, depth1)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=1e-5, atol=1e-5)
    assert (got_v[0] == NEG_INF).all()
    if not depth1:
        assert got_i is None
        return
    empty = want_v <= NEG_INF
    np.testing.assert_array_equal(got_i.numpy()[empty], -1)
    s = np.where(mask != 0, -1e300, Ur.astype(np.float64) @
                 Vr.astype(np.float64).T + b)
    s = np.pad(s, ((0, 0), (0, (-n_i) % CH)), constant_values=-1e300)
    top2 = -np.sort(-s.reshape(n_u, -1, CH), axis=1)[:, :2]
    clear = ~empty
    if top2.shape[1] == 2:
        clear &= (top2[:, 0] - top2[:, 1]) > 1e-4
    np.testing.assert_array_equal(got_i.numpy()[clear], want_g[clear])
    assert clear.sum() > 0.5 * (~empty).sum()


def test_ties_take_the_lowest_index():
    """Equal scores in a residue: the lowest item wins, as in the probe's
    strict ``v > m1``; values equal variant A's."""
    n_u, n_i, d = 4, 700, 3
    U = np.ones((n_u, d), np.float32)
    V = np.ones((n_i, d), np.float32)
    V[500] = 2.0  # one item above the tie in residue 500 % 128
    mask = np.zeros((n_u, n_i), np.int8)
    mask[1, :128] = 1  # row 1: the first block masked, the tie moves on
    b = np.zeros(n_i, np.float32)
    vals, idx = _run(U, V, b, mask, True, True)
    lane = np.arange(CH)
    want = np.broadcast_to(lane, (n_u, CH)).copy()
    want[1] += CH
    want[:, 500 % CH] = 500
    np.testing.assert_array_equal(idx.numpy(), want)
    vals_a, _ = _run(U, V, b, mask, True, False)
    np.testing.assert_array_equal(vals.numpy(), vals_a.numpy())
    want_v, want_g = _probe(U, V, b, mask, True)
    np.testing.assert_array_equal(idx.numpy(), want_g)
    np.testing.assert_array_equal(vals.numpy(), want_v.astype(np.float32))


def test_cpu_wrapper_is_the_plain_version():
    U, V, b, mask = _case(0, 12, 300, 6)
    words = pack_mask(torch.from_numpy(mask))
    args = (torch.from_numpy(U), torch.from_numpy(V), torch.from_numpy(b),
            words)
    tfl.topk_floor.launches = 0
    for exact in (True, False):
        got = tfl.topk_floor(*args, exact, with_index=True)
        want = tfl.topk_floor_plain(*args, exact, with_index=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
        assert tuple(got[0].shape) == (12, CH)
    assert tfl.topk_floor.launches == 0
    with pytest.raises(ValueError, match="excl_bits"):
        tfl.topk_floor(*args[:3], words[:, :1])
