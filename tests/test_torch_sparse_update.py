"""The port's sparse RMSProp against the JAX package's on the same indices
and gradients, with duplicates, padded plan slots and vector tables.

Tolerances: the plans are integers and must be equal. Values are the same
fp32 formula on both sides; XLA may contract a multiply and an add into an
fma and sums duplicates in its own order, which moves a value by an ulp or
two, so they agree to rtol 1e-5 / atol 1e-6 (rows the step does not touch
must stay bitwise equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topk_rec_tpu.ops import sparse_update as jx
from topk_rec_torch.ops import sparse_update as ts

TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, n_rows, k, steps, m, pool=None):
    rng = np.random.default_rng(seed)
    shape = (n_rows,) if k is None else (n_rows, k)
    table = rng.normal(size=shape).astype(np.float32)
    acc = np.abs(rng.normal(size=shape)).astype(np.float32)
    idx = rng.integers(0, pool or n_rows, size=(steps, m)).astype(np.int32)
    idx[0, : m // 2] = idx[0, 0]  # heavy duplication in the first step
    gshape = (steps, m) if k is None else (steps, m, k)
    grads = rng.normal(size=gshape).astype(np.float32)
    return table, acc, idx, grads


def _t(a):
    return torch.from_numpy(np.array(a))


def _dense_reference(table, acc, idx, grads, lr, decay=0.9, eps=1e-10):
    """Summed gradient per row, one accumulator update per touched row."""
    table, acc = table.copy(), acc.copy()
    g = np.zeros_like(table)
    np.add.at(g, idx, grads)
    touched = np.zeros(table.shape[0], bool)
    touched[idx] = True
    acc[touched] = decay * acc[touched] + (1 - decay) * g[touched] ** 2
    table[touched] -= lr * g[touched] / np.sqrt(acc[touched] + eps)
    return table, acc


@pytest.mark.parametrize("steps,m,pool", [(1, 6, 5), (4, 9, None),
                                          (3, 16, 9)])
def test_plan_equals_jax(steps, m, pool):
    _, _, idx, _ = _inputs(0, 17, 3, steps, m, pool)
    j_uniq, j_seg = jx.plan_sparse_updates(jnp.asarray(idx))
    t_uniq, t_seg = ts.plan_sparse_updates(_t(idx))
    np.testing.assert_array_equal(t_uniq.numpy(), np.asarray(j_uniq))
    np.testing.assert_array_equal(t_seg.numpy(), np.asarray(j_seg))
    assert (t_uniq.numpy() == ts.PAD).any(), "the cases must have padding"


def test_planned_rows_equal_jax():
    """Unique rows and accumulators; padded slots read 0 as in JAX."""
    table, acc, idx, _ = _inputs(1, 20, 4, 2, 8, pool=5)
    j_uniq, _ = jx.plan_sparse_updates(jnp.asarray(idx))
    t_uniq, _ = ts.plan_sparse_updates(_t(idx))
    for s in range(2):
        jr, ja = jx.planned_rows(jnp.asarray(table), jnp.asarray(acc),
                                 j_uniq[s])
        tr, ta = ts.planned_rows(_t(table), _t(acc), t_uniq[s])
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        assert (tr.numpy()[t_uniq[s].numpy() == ts.PAD] == 0).all()


def test_apply_planned_equals_jax():
    """planned_rows + segment sum + apply_planned_rmsprop, the split the
    BPR step uses, on a step with duplicates and padded slots."""
    n_rows, k, m = 40, 6, 16
    table, acc, idx, grads = _inputs(8, n_rows, k, 1, m, pool=9)
    j_uniq, j_seg = jx.plan_sparse_updates(jnp.asarray(idx))
    rows, acc_rows = jx.planned_rows(jnp.asarray(table), jnp.asarray(acc),
                                     j_uniq[0])
    agg = jax.ops.segment_sum(jnp.asarray(grads[0]), j_seg[0],
                              num_segments=m)
    jt, ja = jx.apply_planned_rmsprop(jnp.asarray(table), jnp.asarray(acc),
                                      j_uniq[0], rows, acc_rows, agg, 0.1)

    t_uniq, t_seg = ts.plan_sparse_updates(_t(idx))
    tt, ta = _t(table), _t(acc)
    t_rows, t_acc_rows = ts.planned_rows(tt, ta, t_uniq[0])
    t_agg = torch.zeros(m, k).index_add_(0, t_seg[0], _t(grads[0]))
    np.testing.assert_allclose(t_agg.numpy(), np.asarray(agg), **TOL)
    out_t, out_a = ts.apply_planned_rmsprop(tt, ta, t_uniq[0], t_rows,
                                            t_acc_rows, t_agg, 0.1)
    assert out_t is tt and out_a is ta  # in place
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    untouched = np.setdiff1d(np.arange(n_rows), idx)
    np.testing.assert_array_equal(tt.numpy()[untouched], table[untouched])
    np.testing.assert_array_equal(ta.numpy()[untouched], acc[untouched])


@pytest.mark.parametrize("k", [5, None], ids=["matrix", "vector"])
def test_planned_rmsprop_steps_equal_jax(k):
    """A chunk of planned steps on a matrix and on a vector table."""
    table, acc, idx, grads = _inputs(3, 17, k, 4, 9)
    j_uniq, j_seg = jx.plan_sparse_updates(jnp.asarray(idx))
    t_uniq, t_seg = ts.plan_sparse_updates(_t(idx))
    jt, ja = jnp.asarray(table), jnp.asarray(acc)
    tt, ta = _t(table), _t(acc)
    for s in range(4):
        jt, ja = jx.planned_rmsprop(jt, ja, j_uniq[s], j_seg[s],
                                    jnp.asarray(grads[s]), lr=0.05)
        ts.planned_rmsprop(tt, ta, t_uniq[s], t_seg[s], _t(grads[s]),
                           lr=0.05)
        np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)


@pytest.mark.parametrize("k", [4, None], ids=["matrix", "vector"])
def test_sparse_rmsprop_equals_jax_and_dense(k):
    table, acc, idx, grads = _inputs(0, 20, k, 1, 6, pool=8)
    jt, ja = jx.sparse_rmsprop(jnp.asarray(table), jnp.asarray(acc),
                               jnp.asarray(idx[0]), jnp.asarray(grads[0]),
                               lr=0.1)
    tt, ta = ts.sparse_rmsprop(_t(table), _t(acc), _t(idx[0]), _t(grads[0]),
                               lr=0.1)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    want_t, want_a = _dense_reference(table, acc, idx[0], grads[0], lr=0.1)
    np.testing.assert_allclose(tt.numpy(), want_t, **TOL)
    np.testing.assert_allclose(ta.numpy(), want_a, **TOL)
