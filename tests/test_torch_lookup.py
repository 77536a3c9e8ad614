"""The port's all-to-all lookup and update (``topk_rec_torch/parallel/
lookup.py``) against the JAX package's (``topk_rec_tpu/parallel/
lookup.py``).

The port runs in 2 and 4 gloo ranks (``tests/_torch_mesh_ranks.py``), on
the meshes 1x2, 1x4 and 2x2; JAX runs each case on a mesh of the same shape
over the pytest process's virtual CPU devices. Both get the same NumPy
inputs. Gathered rows, validity masks and per-device overflow counts must be
exactly JAX's (the same stable dedup, the same send layout, so the same
uniques overflow); the scatter-add and the owner-side RMSProp agree to
rtol 1e-6.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_mesh_ranks import lookup_body, spawn
from topk_rec_tpu.parallel import make_mesh
from topk_rec_tpu.parallel.lookup import (
    _exchange,
    _exchange_rmsprop,
    sharded_lookup,
    sharded_update,
)

MESHES = [(1, 2), (1, 4), (2, 2)]
UPDATE_TOL = dict(rtol=1e-6, atol=1e-6)


def _cases(mp, pos_u):
    """The inputs of tests/test_lookup.py's cases, sized for ``mp``."""
    rng = np.random.default_rng(5)
    # exact: duplicates within and across devices, capacity = batch
    n_rows, k, B = 64, 6, 48
    idx = rng.integers(0, n_rows, size=B).astype(np.int32)
    idx[::5] = idx[0]
    idx[B // 2:] = idx[:B // 2]
    grads = rng.normal(size=(B, k)).astype(np.float32)
    grads[idx == idx[1]] = 0.0  # a row whose every gradient is zero
    exact = {"table": rng.normal(size=(n_rows, k)).astype(np.float32),
             "idx": idx, "capacity": B,
             "rows": rng.normal(size=(B, k)).astype(np.float32),
             "grads": grads, "lr": 0.05,
             "acc": np.abs(rng.normal(size=(n_rows, k))).astype(np.float32)}
    # skewed: every device asks for 4 rows, all owned by shard 0, capacity 2
    per = 64 // mp
    sidx = np.concatenate([rng.choice(per, size=4, replace=False)
                           for _ in range(mp)]).astype(np.int32)
    skewed = {"table": rng.normal(size=(64, 4)).astype(np.float32),
              "idx": sidx, "capacity": 2,
              "rows": np.ones((4 * mp, 4), np.float32),
              "grads": rng.normal(size=(4 * mp, 4)).astype(np.float32),
              "lr": 0.05,
              "acc": np.abs(rng.normal(size=(64, 4))).astype(np.float32)}
    # default capacity on power-law user ids
    default = {"table": rng.normal(size=(120, 8)).astype(np.float32),
               "idx": pos_u[:64].astype(np.int32), "capacity": 0}
    return {"exact": exact, "skewed": skewed, "default": default}


@pytest.fixture(scope="module")
def cases(small_inter):
    return {shape: _cases(shape[1], small_inter.pos_u) for shape in MESHES}


@pytest.fixture(scope="module")
def port(cases, tmp_path_factory):
    """Every rank's results, per (dp, mp, case): one spawn per world."""
    tmp = tmp_path_factory.mktemp("torch_lookup")
    out = {}
    for world in (2, 4):
        mine = {s: c for s, c in cases.items() if s[0] * s[1] == world}
        ranks = spawn(lookup_body, world, tmp, mine)
        for shape in mine:
            for name in mine[shape]:
                out[shape + (name,)] = [r[shape + (name,)] for r in ranks]
    return out


def _gather(per_rank, key, shape):
    """The batch-split arrays ``key`` of the ranks of dp row 0 in mp order;
    the other dp rows must hold the same values."""
    dp, mp = shape
    rows = [np.concatenate([per_rank[d * mp + m][key] for m in range(mp)])
            for d in range(dp)]
    for other in rows[1:]:
        np.testing.assert_array_equal(other, rows[0])
    return rows[0]


def _jax_mesh(shape):
    return make_mesh(shape[0] * shape[1], dp=shape[0], mp=shape[1])


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["exact", "skewed", "default"])
def test_sharded_lookup_rows_and_overflow_equal_jax(port, cases, shape,
                                                    name):
    """tests/test_lookup.py:12, :25, :49: the rows and per-device overflow
    of ``sharded_lookup``, exactly; dropped occurrences read zero rows."""
    c = cases[shape][name]
    rows, ovf = sharded_lookup(c["table"], c["idx"], _jax_mesh(shape),
                               capacity=c["capacity"])
    got = port[shape + (name,)]
    np.testing.assert_array_equal(_gather(got, "rows", shape),
                                  np.asarray(rows))
    for r in got:
        np.testing.assert_array_equal(r["ovf"], np.asarray(ovf))
    if name == "exact":
        assert np.asarray(ovf).sum() == 0
        np.testing.assert_array_equal(np.asarray(rows), c["table"][c["idx"]])
    if name == "skewed":
        assert np.asarray(ovf).sum() > 0


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["exact", "skewed"])
def test_sharded_update_equals_jax(port, cases, shape, name):
    """tests/test_lookup.py:74, :89: the reverse scatter-add sums
    duplicates within and across devices; under overflow whole uniques are
    dropped, the same ones as in JAX."""
    c = cases[shape][name]
    dp, mp = shape
    new, ovf = sharded_update(c["table"], c["idx"], c["rows"],
                              _jax_mesh(shape), capacity=c["capacity"])
    got = port[shape + (name,)]
    for r, res in enumerate(got):
        np.testing.assert_array_equal(res["update_ovf"], np.asarray(ovf))
    table = np.concatenate([got[m]["update"] for m in range(mp)])
    for d in range(1, dp):
        np.testing.assert_array_equal(
            np.concatenate([got[d * mp + m]["update"] for m in range(mp)]),
            table)
    np.testing.assert_allclose(table, np.asarray(new), **UPDATE_TOL)
    if name == "exact":
        want = c["table"].copy()
        np.add.at(want, c["idx"], c["rows"])
        np.testing.assert_allclose(table, want, rtol=1e-5, atol=1e-6)
    else:
        assert np.asarray(ovf).sum() > 0


def _shard_fn(body, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs))


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("name", ["exact", "skewed"])
def test_exchange_with_valid_mask_equals_jax(port, cases, shape, name):
    """tests/test_lookup.py:118: ``_exchange(with_valid=True)``'s mask is
    False exactly on the dropped occurrences, whose rows are zero."""
    c = cases[shape][name]
    mesh = _jax_mesh(shape)
    per = c["table"].shape[0] // shape[1]
    fn = _shard_fn(
        partial(_exchange, axis="mp", n_shards=shape[1], rows_per_shard=per,
                capacity=c["capacity"], with_valid=True),
        mesh, (P("mp", None), P("mp")), (P("mp", None), P("mp"), P("mp")))
    rows, valid, ovf = fn(
        jax.device_put(jnp.asarray(c["table"]),
                       NamedSharding(mesh, P("mp", None))),
        jax.device_put(jnp.asarray(c["idx"]), NamedSharding(mesh, P("mp"))))
    got = port[shape + (name,)]
    np.testing.assert_array_equal(_gather(got, "x_valid", shape),
                                  np.asarray(valid))
    np.testing.assert_array_equal(_gather(got, "x_rows", shape),
                                  np.asarray(rows))
    np.testing.assert_array_equal(_gather(got, "x_ovf", shape),
                                  np.asarray(ovf))
    assert np.asarray(valid).all() == (name == "exact")


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("name", ["exact", "skewed"])
def test_exchange_rmsprop_equals_jax(port, cases, shape, name):
    """The owner-side RMSProp against JAX's ``_exchange_rmsprop`` under a
    ``shard_map`` on the same inputs: one update per globally touched row
    on its summed gradient. A row whose every gradient is zero still gets
    the apply (lookup.py:287-292): its accumulator decays by 0.9 and the
    row stays where it was."""
    c = cases[shape][name]
    mesh = _jax_mesh(shape)
    mp = shape[1]
    per = c["table"].shape[0] // mp
    fn = _shard_fn(
        partial(_exchange_rmsprop, axis="mp", n_shards=mp,
                rows_per_shard=per, capacity=c["capacity"], lr=c["lr"],
                decay=0.9, eps=1e-10),
        mesh, (P("mp", None), P("mp", None), P("mp"), P("mp", None)),
        (P("mp", None), P("mp", None), P("mp")))
    rows = NamedSharding(mesh, P("mp", None))
    tab, acc, ovf = fn(jax.device_put(jnp.asarray(c["table"]), rows),
                       jax.device_put(jnp.asarray(c["acc"]), rows),
                       jax.device_put(jnp.asarray(c["idx"]),
                                      NamedSharding(mesh, P("mp"))),
                       jax.device_put(jnp.asarray(c["grads"]), rows))
    got = port[shape + (name,)]
    np.testing.assert_array_equal(_gather(got, "rms_ovf", shape),
                                  np.asarray(ovf))
    for key, want in (("rms_table", tab), ("rms_acc", acc)):
        np.testing.assert_allclose(
            np.concatenate([got[m][key] for m in range(mp)]),
            np.asarray(want), **UPDATE_TOL, err_msg=key)
    if name == "exact":
        zero = c["idx"][1]
        port_acc = np.concatenate([got[m]["rms_acc"] for m in range(mp)])
        port_tab = np.concatenate([got[m]["rms_table"] for m in range(mp)])
        np.testing.assert_allclose(port_acc[zero], 0.9 * c["acc"][zero],
                                   rtol=1e-6)
        np.testing.assert_array_equal(port_tab[zero], c["table"][zero])
