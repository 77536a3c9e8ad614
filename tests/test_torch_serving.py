"""The port's TopKServer against the JAX package's, on the CPU.

Every port method rounds its table inputs to bf16 and accumulates in fp32
(the TPU's Precision.DEFAULT). JAX's DEFAULT is full fp32 on the CPU, so
both servers get bf16-rounded tables: the products are then exact in fp32
and the two sides differ only in summation order. Values agree to rtol
1e-5 / atol 1e-5 (a few ulps of ~10-magnitude scores); item ids must be
equal on every finite slot, the scores being continuous and tie-free far
above that noise. The exact methods (``METHODS``) are held to JAX's
``exact``; ``approx`` is held to validity and recall (``test_approx_*``).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from topk_rec_tpu.serving import TopKServer as JaxServer
from topk_rec_torch.data import Interactions as PortInteractions
from topk_rec_torch.interop import from_jax_params
from topk_rec_torch.serving import TopKServer

METHODS = ["exact", "kernel", "hybrid"]
ALL_METHODS = ["exact", "approx", "kernel", "hybrid"]


def _port(inter):
    """The port's own Interactions over the same arrays as ``inter``."""
    return PortInteractions(inter.n_users, inter.n_items, inter.pos_u,
                            inter.pos_i, inter.seen_u, inter.seen_i)


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


def _tables(inter, seed, dim=8, bias=True):
    rng = np.random.default_rng(seed)
    U = _bf16(rng.normal(size=(inter.n_users, dim)).astype(np.float32))
    V = _bf16(rng.normal(size=(inter.n_items, dim)).astype(np.float32))
    b = rng.normal(size=inter.n_items).astype(np.float32) if bias else None
    return U, V, b


def _assert_same(got, want):
    gv, gi = got
    wv, wi = (np.asarray(x) for x in want)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gi[fin], wi[fin])


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("seen_format", ["bitmap", "lists"])
def test_matches_jax_exact(small_inter, method, seen_format):
    U, V, b = _tables(small_inter, 0)
    users = np.array([0, 3, 5, 17, 21, 44, 44, 9])
    jax_srv = JaxServer(U, V, b, small_inter)
    srv = TopKServer(U, V, b, _port(small_inter), seen_format=seen_format,
                     device="cpu")
    _assert_same(srv.recommend(users, k=10, method=method),
                 jax_srv.recommend(users, k=10, method="exact"))


@pytest.mark.parametrize("method", METHODS)
def test_bf16_tables(small_inter, method):
    rng = np.random.default_rng(6)
    U = rng.normal(size=(small_inter.n_users, 8)).astype(np.float32)
    V = rng.normal(size=(small_inter.n_items, 8)).astype(np.float32)
    b = rng.normal(size=small_inter.n_items).astype(np.float32)
    srv = TopKServer(U, V, b, _port(small_inter), table_dtype=torch.bfloat16,
                     device="cpu")
    assert srv.U.dtype == torch.bfloat16 and srv.V.dtype == torch.bfloat16
    assert srv.bias.dtype == torch.float32
    jax_srv = JaxServer(_bf16(U), _bf16(V), b, small_inter)
    users = np.array([0, 5, 17, 44])
    _assert_same(srv.recommend(users, k=10, method=method),
                 jax_srv.recommend(users, k=10, method="exact"))


@pytest.mark.parametrize("method", ALL_METHODS)
def test_seen_items_never_served(small_inter, method):
    U, V, b = _tables(small_inter, 1, bias=False)
    srv = TopKServer(U, V, b, _port(small_inter), device="cpu")
    users = small_inter.rated_users[:20]
    vals, idx = srv.recommend(users, k=20, method=method)
    pos = set(zip(small_inter.seen_u.tolist(), small_inter.seen_i.tolist()))
    for row, u in enumerate(users):
        for v, item in zip(vals[row], idx[row]):
            if np.isfinite(v):
                assert (int(u), int(item)) not in pos


@pytest.mark.parametrize("method", ALL_METHODS)
def test_recommend_async_matches_sync(small_inter, method):
    U, V, _ = _tables(small_inter, 9, dim=6)
    srv = TopKServer(U, V, None, _port(small_inter), device="cpu")
    uids = np.random.default_rng(9).integers(0, small_inter.n_users, 16)
    sv, si = srv.recommend(uids, k=7, method=method)
    futs = [srv.recommend_async(uids, k=7, method=method) for _ in range(3)]
    for fv, fi in futs:
        assert isinstance(fv, torch.Tensor)
        np.testing.assert_array_equal(fv.numpy(), sv)
        np.testing.assert_array_equal(fi.numpy(), si)


def test_exclude_seen_off_and_buffers(small_inter):
    U, V, b = _tables(small_inter, 2)
    srv = TopKServer(U, V, b, _port(small_inter), exclude_seen=False,
                     device="cpu")
    jax_srv = JaxServer(U, V, b, small_inter, exclude_seen=False)
    users = np.arange(8)
    for method in METHODS:
        _assert_same(srv.recommend(users, k=5, method=method),
                     jax_srv.recommend(users, k=5))
    names = {n for n, _ in srv.named_buffers()}
    assert names == {"U", "V", "bias", "seen"}


@pytest.mark.parametrize("dim,table_dtype", [(8, None), (16, torch.bfloat16)],
                         ids=["copies", "aliases"])
def test_kernel_tables_follow_u_and_v(small_inter, dim, table_dtype):
    """The kernel methods' copies of U and V, forced here as the card makes
    them (``kernel_table``), follow the tables through ``load_state_dict``
    and an in-place edit, so that ``kernel`` and ``hybrid`` keep serving
    what ``exact`` serves; tables that did not change are not copied
    again. bf16 tables whose d is a multiple of 16 are their own kernel
    form: there is no copy, and U itself is served."""
    from topk_rec_torch.ops.topk_fused import kernel_table

    U, V, b = _tables(small_inter, 11, dim=dim)
    U2, V2, b2 = _tables(small_inter, 12, dim=dim)
    users = np.array([0, 3, 5, 17, 21, 44])
    kw = dict(table_dtype=table_dtype, device="cpu")
    srv = TopKServer(U, V, b, _port(small_inter), **kw)
    other = TopKServer(U2, V2, b2, _port(small_inter), **kw)
    srv.U_kernel = kernel_table(srv.U, exact_matmul=False)
    srv.V_kernel = kernel_table(srv.V, exact_matmul=False)
    assert (srv.U_kernel is srv.U) == (table_dtype is not None)

    def served():
        want = srv.recommend(users, k=10, method="exact")
        for method in ("kernel", "hybrid"):
            _assert_same(srv.recommend(users, k=10, method=method), want)
        return want

    first = served()
    held = srv.U_kernel, srv.V_kernel
    served()
    assert srv.U_kernel is held[0] and srv.V_kernel is held[1]
    srv.load_state_dict(other.state_dict())
    assert not np.array_equal(served()[1], first[1])
    srv.U.copy_(torch.from_numpy(U[::-1].copy()).to(srv.U.dtype))
    served()
    assert (srv.U_kernel is srv.U) == (table_dtype is not None)


def test_unsupported_options_raise(small_inter):
    U, V, b = _tables(small_inter, 3)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        TopKServer(U, V, b, _port(small_inter), mesh=object(), device="cpu")
    srv = TopKServer(U, V, b, _port(small_inter), device="cpu")
    # JAX's name for the fused kernel; the port's is "kernel"
    with pytest.raises(ValueError, match="unknown method"):
        srv.recommend(np.arange(2), k=3, method="pallas")


def _approx_valid_with_recall(got, U, V, b, inter, users, k):
    """Served approx lists: each finite slot is an unseen item carrying its
    own bf16-table score, values descend, and the mean recall@k against the
    float64 exact list is at least 0.9."""
    vals, idx = got
    Ub = _bf16(U).astype(np.float64)
    Vb = _bf16(V).astype(np.float64)
    ref = Ub[users] @ Vb.T + (0.0 if b is None else b[None, :])
    seen = set(zip(inter.seen_u.tolist(), inter.seen_i.tolist()))
    recall = []
    for row, u in enumerate(users):
        for r, i in seen:
            if r == u:
                ref[row, i] = -np.inf
        fin = np.isfinite(vals[row])
        items = idx[row][fin]
        assert all((int(u), int(i)) not in seen for i in items)
        np.testing.assert_allclose(vals[row][fin], ref[row, items],
                                   rtol=1e-5, atol=1e-5)
        assert (np.diff(vals[row]) <= 0).all()
        want = np.argsort(-ref[row], kind="stable")[:k]
        want = want[np.isfinite(ref[row, want])]
        recall.append(len(set(items) & set(want)) / max(1, len(want)))
    assert np.mean(recall) >= 0.9


@pytest.mark.parametrize("seen_format", ["bitmap", "lists"])
def test_approx_valid_with_recall(small_inter, seen_format):
    U, V, b = _tables(small_inter, 0)
    users = np.array([0, 3, 5, 17, 21, 44, 44, 9])
    srv = TopKServer(U, V, b, _port(small_inter), seen_format=seen_format,
                     device="cpu")
    got = srv.recommend(users, k=10, method="approx")
    _approx_valid_with_recall(got, U, V, b, small_inter, users, 10)


def test_approx_bf16_tables(small_inter):
    rng = np.random.default_rng(6)
    U = rng.normal(size=(small_inter.n_users, 8)).astype(np.float32)
    V = rng.normal(size=(small_inter.n_items, 8)).astype(np.float32)
    srv = TopKServer(U, V, None, _port(small_inter),
                     table_dtype=torch.bfloat16, device="cpu")
    users = np.array([0, 5, 17, 44])
    got = srv.recommend(users, k=10, method="approx")
    _approx_valid_with_recall(got, U, V, None, small_inter, users, 10)


def test_large_catalog_approx_reduces_and_hybrid_stays_exact():
    """3,000 items: the selector keeps 256 bins of 16 items at k = 10, so
    approx may lose items, while hybrid still equals JAX's exact."""
    from topk_rec_tpu.data.dataset import synthetic_interactions
    from topk_rec_torch.ops.topk_hybrid import approx_bins

    inter = synthetic_interactions(n_users=40, n_items=3000, n_pos=2000,
                                   seed=3)
    assert approx_bins(inter.n_items, 10, 0.95) == (256, 4)
    U, V, b = _tables(inter, 8)
    users = np.arange(0, 40, 3)
    srv = TopKServer(U, V, b, _port(inter), device="cpu")
    _approx_valid_with_recall(srv.recommend(users, k=10, method="approx"),
                              U, V, b, inter, users, 10)
    want = JaxServer(U, V, b, inter).recommend(users, k=10, method="exact")
    _assert_same(srv.recommend(users, k=10, method="hybrid"), want)


def test_trained_bpr_through_from_jax_params(small_inter):
    """JAX BPR trained briefly, carried across with from_jax_params and
    TopKServer.from_model: both servers return the same items."""
    from topk_rec_tpu.models import BPR

    model = BPR(k=8, seed=0, lr=0.05)
    model.set_interactions(small_inter)
    model.train(epochs=1, batch_size=64, verbose=False)
    model.fue, model.fie = _bf16(model.fue), _bf16(model.fie)
    jax_srv = JaxServer.from_model(model)
    U, V, bias = from_jax_params(model, "cpu")
    assert U.dtype == torch.float32 and bias.shape == (small_inter.n_items,)
    users = np.arange(0, small_inter.n_users, 7)
    want = jax_srv.recommend(users, k=10)
    for srv in (TopKServer(U, V, bias, _port(small_inter), device="cpu"),
                TopKServer.from_model(model, device="cpu")):
        for method in METHODS:
            _assert_same(srv.recommend(users, k=10, method=method), want)
    Ud, Vd, Bd = from_jax_params(
        {"U": model.fue, "V": model.fie, "B": model.fib}, "cpu",
        table_dtype=torch.bfloat16,
    )
    assert Ud.dtype == torch.bfloat16 and torch.equal(Ud.float(), U)
    assert torch.equal(Bd, bias)
