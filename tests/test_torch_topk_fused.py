"""The port's fused top-k (plain twin on the CPU) against the JAX package's
Pallas kernel in interpret mode, on the cases of tests/test_topk_pallas.py.

Tolerances: values agree to rtol 1e-5 / atol 1e-5. Both sides compute fp32
dot products of the same inputs but sum them in different orders (XLA's
CPU dot vs torch's), which moves a score of magnitude ~10 by a few ulps
(~1e-6). Indices must be equal on every non-excluded slot: the inputs are
continuous random values (tie-free far above that noise), or ties planted
as exact equal rows, which both sides order by lowest index.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from topk_rec_tpu.ops import topk_pallas as jx
from topk_rec_torch.ops import topk_fused as tf

NEG_INF = np.float32(np.finfo(np.float32).min)


def _pack(mask: np.ndarray) -> np.ndarray:
    """int8 [rows, n] -> uint32 words [rows, ceil(n/32)], bit c&31 of c>>5."""
    rows, n = mask.shape
    bits = np.zeros((rows, -(-n // 32) * 32), np.uint8)
    bits[:, :n] = mask != 0
    return np.ascontiguousarray(
        np.packbits(bits, axis=1, bitorder="little")
    ).view("<u4")


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


def _run_both(U, V, bias, mask, k, block_u, block_i, exact=True):
    jv, ji = jx.fused_score_topk(
        jnp.asarray(U), jnp.asarray(V),
        None if bias is None else jnp.asarray(bias), jnp.asarray(mask), k,
        block_u=block_u, block_i=block_i, interpret=True, exact_matmul=exact,
    )
    words = torch.from_numpy(_pack(mask).view(np.int32))
    tv, ti = tf.fused_score_topk(
        torch.from_numpy(U), torch.from_numpy(V),
        None if bias is None else torch.from_numpy(bias), words, k,
        exact_matmul=exact,
    )
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


def _assert_same(jv, ji, tv, ti):
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    live = jv > NEG_INF
    np.testing.assert_array_equal(tv > NEG_INF, live)
    np.testing.assert_array_equal(ti[live], ji[live])
    assert (ti[~live] == -1).all()  # empty slots carry index -1


def _random(n_u, n_i, d, density, seed, bias=True):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_u, d)).astype(np.float32)
    V = rng.normal(size=(n_i, d)).astype(np.float32)
    b = rng.normal(size=n_i).astype(np.float32) if bias else None
    mask = (rng.random((n_u, n_i)) < density).astype(np.int8)
    return U, V, b, mask


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("n_u,n_i,d,k", [(64, 96, 16, 8), (130, 300, 20, 30)])
def test_ragged_shapes(n_u, n_i, d, k, exact):
    U, V, b, mask = _random(n_u, n_i, d, 0.2, 0)
    if not exact:
        # JAX's DEFAULT precision is full fp32 on the CPU: feed both sides
        # bf16-rounded inputs, whose products are exact in fp32
        U, V = _bf16(U), _bf16(V)
    _assert_same(*_run_both(U, V, b, mask, k, 32, 128, exact))


@pytest.mark.parametrize("exact", [True, False])
def test_no_bias_and_fewer_than_k_unseen(exact):
    rng = np.random.default_rng(1)
    U = _bf16(rng.normal(size=(8, 4)).astype(np.float32))
    V = _bf16(rng.normal(size=(10, 4)).astype(np.float32))
    mask = np.zeros((8, 10), np.int8)
    mask[0, :] = 1
    mask[0, 3] = 0  # user 0 has exactly one unseen item
    jv, ji, tv, ti = _run_both(U, V, None, mask, 5, 8, 128, exact)
    _assert_same(jv, ji, tv, ti)
    assert ti[0, 0] == 3 and (tv[0, 1:] == NEG_INF).all()


@pytest.mark.parametrize("exact", [True, False])
def test_all_ties(exact):
    U = np.ones((16, 2), np.float32)
    V = np.ones((384, 2), np.float32)
    mask = np.zeros((16, 384), np.int8)
    mask[:, 1] = 1  # the lowest index is excluded: ties start at 0, 2, 3
    jv, ji, tv, ti = _run_both(U, V, None, mask, 6, 8, 384, exact)
    _assert_same(jv, ji, tv, ti)
    assert list(ti[0]) == [0, 2, 3, 4, 5, 6]


def test_span_merged_large_catalog():
    """JAX processes this catalog in column spans (3 tiles of 128); the
    port has no spans. Cross-span exact ties are planted."""
    U, V, b, mask = _random(48, 1500, 12, 0.1, 7)
    V[700] = V[10]
    V[1300] = V[10]
    b[700] = b[10]
    b[1300] = b[10]
    _assert_same(*_run_both(U, V, b, mask, 16, 16, 128))


@pytest.mark.parametrize("exact", [True, False])
def test_large_k(exact):
    U, V, _, mask = _random(32, 768, 8, 0.1, 11, bias=False)
    if not exact:
        U, V = _bf16(U), _bf16(V)
    _assert_same(*_run_both(U, V, None, mask, 64, 16, 256, exact))


def test_group_collisions():
    """The adversarial placements of tests/test_topk_pallas.py, where the
    TPU kernel needs its suspect fallback; the port is exact throughout."""
    n_i = 768
    U = np.ones((8, 1), np.float32)
    V = np.full((n_i, 1), -5.0, np.float32)
    for col, s in [(7, 100.0), (135, 99.0), (263, 98.0), (391, 97.0),
                   (519, 96.0), (11, 50.0)]:
        V[col, 0] = s
    mask = np.zeros((8, n_i), np.int8)
    jv, ji, tv, ti = _run_both(U, V, None, mask, 6, 8, 256)
    _assert_same(jv, ji, tv, ti)
    assert list(ti[0]) == [7, 135, 263, 391, 519, 11]


def test_bf16_tables_equal_rounded_fp32():
    """exact_matmul=False on fp32 inputs == fp32 exact mode on the
    bf16-rounded inputs, bit for bit (the same products and sums)."""
    U, V, b, mask = _random(40, 200, 24, 0.2, 3)
    words = torch.from_numpy(_pack(mask).view(np.int32))
    v1, i1 = tf.fused_score_topk(
        torch.from_numpy(U), torch.from_numpy(V), torch.from_numpy(b), words,
        10, exact_matmul=False,
    )
    v2, i2 = tf.fused_score_topk(
        torch.from_numpy(_bf16(U)), torch.from_numpy(_bf16(V)),
        torch.from_numpy(b), words, 10,
    )
    v3, i3 = tf.fused_score_topk(
        torch.from_numpy(U).bfloat16(), torch.from_numpy(V).bfloat16(),
        torch.from_numpy(b), words, 10,
    )
    for v, i in ((v2, i2), (v3, i3)):
        assert torch.equal(v1, v) and torch.equal(i1, i)


@pytest.mark.parametrize("n_items", [100, 64, 31])
def test_expand_and_pack_candidate_bitmap(n_items):
    rng = np.random.default_rng(2)
    n_users = 40
    dense = rng.random((n_users, n_items)) < 0.3
    bm = _pack(dense.astype(np.int8))
    cand = rng.choice(n_items, size=min(37, n_items), replace=False)
    want = jx.pack_candidate_bitmap(bm, cand)
    got = tf.pack_candidate_bitmap(bm, cand)
    np.testing.assert_array_equal(got, want)
    n_cand = len(cand)
    want_mask = np.asarray(jx.expand_seen_mask(jnp.asarray(want), n_cand))
    got_mask = tf.expand_seen_mask(tf.bitmap_tensor(got, "cpu"), n_cand)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    # pack_mask inverts expand_seen_mask, bit 31 included
    np.testing.assert_array_equal(
        tf.pack_mask(got_mask).numpy().view(np.uint32), got
    )


def test_wrapper_rejects_bad_inputs():
    U = torch.zeros(4, 3)
    V = torch.zeros(40, 3)
    with pytest.raises(ValueError, match="excl_bits"):
        tf.fused_score_topk(U, V, None, torch.zeros(4, 1, dtype=torch.int32), 5)
    with pytest.raises(ValueError, match="k must be"):
        tf.fused_score_topk(U, V, None, torch.zeros(4, 2, dtype=torch.int32),
                            129)
    with pytest.raises(ValueError, match="agree on d"):
        tf.fused_score_topk(U, torch.zeros(40, 2), None,
                            torch.zeros(4, 2, dtype=torch.int32), 5)


def _csrc_constant(source, name):
    """An ``int`` constant as the kernel source declares it."""
    import os
    import re

    path = os.path.join(os.path.dirname(tf.__file__), "..", "csrc", source)
    with open(path) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


def _geometries():
    """(name, rows per block, item tile, most splits) of K1 (fp32 and bf16),
    K2 and P1, from the kernel sources."""
    k1_tile = _csrc_constant("topk_fused.cu", "kBN")
    return [
        ("K1", _csrc_constant("topk_fused.cu", "kBMFp32"), k1_tile, 32),
        ("K1", _csrc_constant("topk_fused.cu", "kBMBf16"), k1_tile, 32),
        ("K2", _csrc_constant("topk_count.cu", "kCountBM"),
         _csrc_constant("topk_count.cu", "kCountBN"), 65535),
        ("P1", _csrc_constant("topk_floor.cu", "kFloorBM"),
         _csrc_constant("topk_floor.cu", "kFloorBN"),
         _csrc_constant("topk_floor.cu", "kFloorMaxSplits")),
    ]


@pytest.mark.parametrize("slots", [1, 132, 264, 528])
@pytest.mark.parametrize("n_u", [1, 5, 256, 8192, 69878])
def test_item_splits_cover_the_catalog(n_u, slots):
    """The splits K1, K2 and P1 launch cover the catalog exactly, each is a
    whole number of the kernel's item tiles, and K1 and P1 (whose splits
    meet in a merge of at most 32 lists) never take more than 32."""
    for name, rows, tile, most in _geometries():
        for n_i in (1, 100, 127, 128, 129, 4173, 10380, 100000):
            split_len, n_splits = tf.item_splits(n_u, n_i, rows, tile,
                                                 slots, most)
            assert split_len % tile == 0 and split_len > 0, name
            assert split_len * (n_splits - 1) < n_i <= split_len * n_splits
            assert 1 <= n_splits <= most, name
            if name != "K2":
                assert n_splits <= 32
            row_blocks = -(-n_u // rows)
            if row_blocks >= slots:  # enough rows: the catalog stays whole
                assert n_splits == 1, name
