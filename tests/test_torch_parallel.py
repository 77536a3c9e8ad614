"""The port's mesh (``topk_rec_torch/parallel``) against the JAX package's
(``topk_rec_tpu/parallel``): the distributed trainers, the distributed ALS
sweep behind WMF and CER, the data-parallel encoder fit, sharded serving
and the 2-D scoring grid.

The port runs in 4 gloo ranks (``tests/_torch_mesh_ranks.py``) on 2x2 and
1x4 meshes; JAX runs on meshes of the same shapes over the pytest process's
virtual CPU devices. Both start from the same NumPy state. The trainers get
the same triplets: the port's sampler draws them here, the ranks take them
as arguments, and JAX's sampler is replaced by one that returns them (as
``tests/test_torch_vbpr.py`` does). Tolerances are those of
``tests/test_parallel.py``: rtol 2e-4 / atol 1e-5 for a training chunk,
rtol 1e-4 (of the largest entry) for the ALS family; lookup overflow
counts and the capacity-doubling sequence are exact.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import topk_rec_tpu.models.vbpr as jvbpr
import topk_rec_tpu.ops.sampling as jsampling
from _torch_mesh_ranks import als_body, serving_body, spawn, trainers_body
from topk_rec_tpu.models import BPR as JaxBPR
from topk_rec_tpu.models import CER as JaxCER
from topk_rec_tpu.models import VBPR as JaxVBPR
from topk_rec_tpu.models import WMF as JaxWMF
from topk_rec_tpu.models import MLPEncoder as JaxMLP
from topk_rec_tpu.ops.als import ALSPlan as JaxPlan
from topk_rec_tpu.parallel import (
    DistributedALS as JaxDALS,
    DistributedBPRTrainer as JaxBPRTrainer,
    DistributedVBPRTrainer as JaxVBPRTrainer,
    fetch,
    make_mesh,
    shard_params,
)
from topk_rec_tpu.parallel.mesh import BPR_PARAM_SPECS
from topk_rec_tpu.parallel.train_step import (
    distributed_scores_topk as jax_scores_topk,
)
from topk_rec_tpu.serving import TopKServer as JaxServer
from topk_rec_torch.data import Interactions as PortInteractions
from topk_rec_torch.models import BPR, VBPR, MLPEncoder
from topk_rec_torch.models import vbpr as tvbpr
from topk_rec_torch.models.bpr import BPRTables, run_chunk

CHUNK_TOL = dict(rtol=2e-4, atol=1e-5)
K, LR, STEPS, BATCH = 8, 0.05, 4, 64


def _arrays(inter):
    return (inter.n_users, inter.n_items, inter.pos_u, inter.pos_i,
            inter.seen_u, inter.seen_i)


def _port(inter):
    return PortInteractions(*_arrays(inter))


def _jax_mesh(shape):
    return make_mesh(shape[0] * shape[1], dp=shape[0], mp=shape[1])


def _rows(rng, *shape, scale=0.1):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _close(got, want, **kw):
    """rtol 1e-4 of the table's largest entry."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()), **kw)


# ---------------------------------------------------------------------------
# the BPR and VBPR trainers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_inputs(small_inter):
    rng = np.random.default_rng(42)
    n_u, n_i = small_inter.n_users, small_inter.n_items
    params = {"ue": _rows(rng, n_u, K), "ie": _rows(rng, n_i, K),
              "ib": _rows(rng, n_i)}
    ms = {n: np.abs(_rows(rng, *v.shape)) + 0.01 for n, v in params.items()}
    model = BPR(k=K, device="cpu")
    model.set_interactions(_port(small_inter))
    u, i, j = (t.numpy() for t in model.sample_chunk(
        torch.Generator().manual_seed(7), STEPS, BATCH))
    d, kh = 12, K // 2
    feat = rng.normal(size=(n_i, d)).astype(np.float32)
    vparams = {"ure": _rows(rng, n_u, kh), "uce": _rows(rng, n_u, kh),
               "ire": _rows(rng, n_i, kh), "irb": _rows(rng, n_i),
               "cem": _rows(rng, d, kh, scale=0.01),
               "icb": _rows(rng, d, scale=0.01)}
    vms = {n: np.abs(_rows(rng, *v.shape)) + 0.01
           for n, v in vparams.items()}
    return {"params": params, "ms": ms, "u": u, "i": i, "j": j,
            "feat": feat, "vparams": vparams, "vms": vms}


BPR_CASES = {  # name: (mesh, exchange, capacity)
    "gspmd": ((2, 2), "gspmd", 0),
    "explicit": ((1, 4), "explicit", BATCH),
    "forced": ((1, 4), "explicit", 1),
}


@pytest.fixture(scope="module")
def port_trainers(small_inter, train_inputs, tmp_path_factory):
    t = train_inputs
    bpr_cases = {
        name: {"mesh": mesh, "exchange": ex, "capacity": cap, "k": K,
               "lr": LR, "params": t["params"], "ms": t["ms"],
               "u": t["u"], "i": t["i"], "j": t["j"]}
        for name, (mesh, ex, cap) in BPR_CASES.items()}
    vbpr_case = {"mesh": (2, 2), "k": K, "lr": LR, "params": t["vparams"],
                 "ms": t["vms"], "u": t["u"], "i": t["i"], "j": t["j"]}
    return spawn(trainers_body, 4, tmp_path_factory.mktemp("trainers"),
                 _arrays(small_inter), t["feat"], bpr_cases, vbpr_case,
                 (1, 4), _jax_trainer_state(small_inter, t))


def _jax_trainer_state(small_inter, t):
    """The params and ms of a JAX trainer on a 2x2 mesh, read back whole
    with ``fetch``."""
    model = JaxBPR(k=K)
    model.set_interactions(small_inter)
    model._params = {n: jnp.asarray(v) for n, v in t["params"].items()}
    model._ms = {n: jnp.asarray(v) for n, v in t["ms"].items()}
    tr = JaxBPRTrainer(model, _jax_mesh((2, 2)), batch_size=BATCH)
    return ({n: fetch(v) for n, v in tr.params.items()},
            {n: fetch(v) for n, v in tr.ms.items()})


def test_interop_round_trips_sharded_params(port_trainers, small_inter,
                                            train_inputs):
    """A JAX trainer's fetched state goes onto the port's 2x2 mesh (rank
    (d, m) holds block m of each row-sharded table) and comes back, and
    back again onto JAX's mesh, unchanged."""
    want = _jax_trainer_state(small_inter, train_inputs)
    for rank, r in enumerate(port_trainers):
        (params, ms), shards = r["interop"]
        for got, ref in ((params, want[0]), (ms, want[1])):
            for n in ("ue", "ie", "ib"):
                np.testing.assert_array_equal(got[n], ref[n], err_msg=n)
        m = rank % 2
        for n, block in shards.items():
            per = want[0][n].shape[0] // 2
            np.testing.assert_array_equal(
                block, want[0][n][m * per:(m + 1) * per], err_msg=n)
    mesh = _jax_mesh((2, 2))
    placed = shard_params(mesh, port_trainers[0]["interop"][0][0],
                          BPR_PARAM_SPECS)
    for n, a in placed.items():
        np.testing.assert_array_equal(fetch(a), want[0][n])


def _fixed_triplets(t):
    def draw(key, user_rows, flat_pos, pos_bitmap, n, n_items, k_candidates):
        assert n == STEPS * BATCH
        return tuple(jnp.asarray(t[x].reshape(-1)) for x in "uij")
    return draw


def _jax_bpr_chunk(small_inter, t, monkeypatch, mesh, **kw):
    monkeypatch.setattr(jsampling, "_sample_triplets", _fixed_triplets(t))
    model = JaxBPR(k=K, lr=LR, lambda_b=0.01)
    model.set_interactions(small_inter)
    model._params = {n: jnp.asarray(v) for n, v in t["params"].items()}
    model._ms = {n: jnp.asarray(v) for n, v in t["ms"].items()}
    tr = JaxBPRTrainer(model, _jax_mesh(mesh), batch_size=BATCH,
                       scan_steps=STEPS, **kw)
    loss = tr.train_chunk(jax.random.PRNGKey(0))
    tr.sync_to_model()
    return (loss, tr.last_overflow,
            {n: np.asarray(v) for n, v in model._params.items()},
            {n: np.asarray(v) for n, v in model._ms.items()})


def _same_on_every_rank(ranks, name):
    """Every rank holds the same full state, bit for bit: the dp replicas
    of each shard stayed identical."""
    first = ranks[0][name]
    for r in ranks[1:]:
        assert r[name][:2] == first[:2]
        for a, b in zip(r[name][2], first[2]):
            for n in a:
                np.testing.assert_array_equal(a[n], b[n], err_msg=n)
    return first


@pytest.mark.parametrize("name", ["gspmd", "explicit", "forced"])
def test_distributed_bpr_chunk_equals_jax(port_trainers, small_inter,
                                          train_inputs, monkeypatch, name):
    """tests/test_parallel.py:20, :223, tests/test_lookup.py:192: one chunk
    on the same triplets gives JAX's tables, accumulators and loss; the
    forced overflow (capacity 1) drops JAX's count of uniques."""
    mesh, ex, cap = BPR_CASES[name]
    loss, ovf, (params, ms) = _same_on_every_rank(port_trainers, name)
    extra = {} if ex == "gspmd" else {"exchange": ex, "capacity": cap}
    w_loss, w_ovf, w_params, w_ms = _jax_bpr_chunk(
        small_inter, train_inputs, monkeypatch, mesh, **extra)
    assert ovf == w_ovf
    assert (ovf > 0) == (name == "forced")
    np.testing.assert_allclose(loss, w_loss, rtol=1e-5)
    for got, want in ((params, w_params), (ms, w_ms)):
        for n in ("ue", "ie", "ib"):
            assert np.isfinite(got[n]).all()
            np.testing.assert_allclose(got[n], want[n], **CHUNK_TOL,
                                       err_msg=n)


@pytest.mark.parametrize("name", ["gspmd", "explicit"])
def test_distributed_bpr_chunk_equals_local_run_chunk(port_trainers,
                                                      train_inputs, name):
    """Without overflow the mesh computes what the single-device
    ``run_chunk`` computes on the same triplets."""
    t = train_inputs
    loss, _, (params, ms) = _same_on_every_rank(port_trainers, name)
    tables = BPRTables(*(torch.tensor(t["params"][n])
                         for n in ("ue", "ie", "ib")))
    tables.load(ms=t["ms"])
    model = BPR(k=K, lr=LR, lambda_b=0.01, device="cpu")
    want = run_chunk(tables, *(torch.from_numpy(t[x]) for x in "uij"),
                     model.hyper(), "l2")
    np.testing.assert_allclose(loss, float(want), rtol=1e-5)
    for got, ref in ((params, tables.params()), (ms, tables.ms())):
        for n in ("ue", "ie", "ib"):
            np.testing.assert_allclose(got[n], ref[n].numpy(), **CHUNK_TOL,
                                       err_msg=n)


def test_distributed_vbpr_chunk_equals_jax_and_local(port_trainers,
                                                     small_inter,
                                                     train_inputs,
                                                     monkeypatch):
    """tests/test_parallel.py:139: the VBPR chunk on a 2x2 mesh (features
    row-sharded, cem and icb replicated with their gradients summed over
    the ranks) equals JAX's and the single-device ``run_chunk``."""
    t = train_inputs
    loss, _, (params, ms) = _same_on_every_rank(port_trainers, "vbpr")
    monkeypatch.setattr(jvbpr, "_sample_triplets", _fixed_triplets(t))
    model = JaxVBPR(k=K, d=t["feat"].shape[1], lr=LR, lambda_b=0.01,
                    lambda_e=0.02)
    model.set_interactions(small_inter)
    model.set_features(t["feat"])
    model._params = {n: jnp.asarray(v) for n, v in t["vparams"].items()}
    model._ms = {n: jnp.asarray(v) for n, v in t["vms"].items()}
    tr = JaxVBPRTrainer(model, _jax_mesh((2, 2)), batch_size=BATCH,
                        scan_steps=STEPS)
    w_loss = tr.train_chunk(jax.random.PRNGKey(0))
    tr.sync_to_model()
    np.testing.assert_allclose(loss, w_loss, rtol=1e-5)
    local = VBPR(k=K, d=t["feat"].shape[1], lr=LR, lambda_b=0.01,
                 lambda_e=0.02, device="cpu")
    tables = tvbpr.VBPRTables({n: torch.tensor(v)
                               for n, v in t["vparams"].items()})
    tables.load(ms=t["vms"])
    tvbpr.run_chunk(tables, torch.from_numpy(t["feat"]),
                    *(torch.from_numpy(t[x]) for x in "uij"), local.hyper(),
                    "l2")
    for n in tvbpr.NAMES:
        np.testing.assert_allclose(params[n], np.asarray(model._params[n]),
                                   **CHUNK_TOL, err_msg=n)
        np.testing.assert_allclose(ms[n], np.asarray(model._ms[n]),
                                   **CHUNK_TOL, err_msg=n)
        np.testing.assert_allclose(params[n], tables.params()[n].numpy(),
                                   **CHUNK_TOL, err_msg=n)


def test_exchange_auto_is_gspmd_on_one_host(port_trainers):
    """tests/test_parallel.py:262: on one host "auto" picks gspmd, even on
    a pure-mp mesh (the ranks' host names are all the same)."""
    assert [r["auto"] for r in port_trainers] == ["gspmd"] * 4


# ---------------------------------------------------------------------------
# DistributedALS, WMF and CER with a mesh, the data-parallel encoder fit
# ---------------------------------------------------------------------------


def _sweeps(inter):
    """tests/test_parallel.py:89, :113: a user sweep without a prior and an
    item sweep with one."""
    rng = np.random.default_rng(4)
    U = rng.normal(size=(inter.n_users, 6)).astype(np.float32)
    V = rng.normal(size=(inter.n_items, 6)).astype(np.float32)
    rng = np.random.default_rng(5)
    U5 = rng.normal(size=(inter.n_users, 5)).astype(np.float32)
    V5 = rng.normal(size=(inter.n_items, 5)).astype(np.float32)
    prior = rng.normal(size=(inter.n_items, 5)).astype(np.float32)
    return {
        "user": {"side": "user", "this": U, "other": V, "lam": 0.05,
                 "prior": None, "block": 40},
        "item_prior": {"side": "item", "this": V5, "other": U5, "lam": 10.0,
                       "prior": prior, "block": 16},
    }


ENC = dict(k=6, d=24, hidden_layers=(32, 16), seed=3, lr=1e-2, batch_size=32)


def _encoder_data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(100, 24)).astype(np.float32)
    W = rng.normal(size=(24, 6)).astype(np.float32)
    return X, np.tanh(X @ W).astype(np.float32)


@pytest.fixture(scope="module")
def cer_feat(small_inter):
    return np.random.default_rng(9).normal(
        size=(small_inter.n_items, 10)).astype(np.float32)


@pytest.fixture(scope="module")
def port_als(small_inter, cer_feat, tmp_path_factory):
    X, Y = _encoder_data()
    enc = {"k": ENC["k"], "lr": ENC["lr"], "X": X, "Y": Y,
           "hidden": ENC["hidden_layers"],
           "seed": ENC["seed"], "batch": ENC["batch_size"],
           "state": JaxMLP(**ENC).state_dict()}
    return spawn(als_body, 4, tmp_path_factory.mktemp("als"), (2, 2),
                 _arrays(small_inter), _sweeps(small_inter), cer_feat, enc)


@pytest.mark.parametrize("name", ["user", "item_prior"])
def test_distributed_als_equals_jax(port_als, small_inter, name):
    """``DistributedALS.half_sweep``, with and without a prior, gives JAX's
    ``DistributedALS`` result and fit on every rank."""
    s = _sweeps(small_inter)[name]
    inter = small_inter
    indptr, flat = inter.user_csr if s["side"] == "user" else inter.item_csr
    n_this = inter.n_users if s["side"] == "user" else inter.n_items
    rated = inter.rated_items if s["side"] == "user" else inter.rated_users
    plan = JaxPlan(indptr, flat, n_this, block_size=s["block"])
    want, want_fit = JaxDALS(_jax_mesh((2, 2))).half_sweep(
        plan, s["this"], s["other"], jnp.asarray(rated), 1.0, 0.01, s["lam"],
        prior=s["prior"])
    for r in port_als:
        got, fit = r[name]
        _close(got, want)
        np.testing.assert_allclose(fit, want_fit, rtol=1e-4)


def test_wmf_and_cer_with_a_mesh_equal_jax(port_als, small_inter, cer_feat):
    """tests/test_parallel.py:184, :200: WMF (3 iterations) and CER (2)
    trained with a 2x2 mesh equal the JAX models trained with one."""
    wmf = JaxWMF(k=6, seed=3, mesh=_jax_mesh((2, 2)))
    wmf.set_interactions(small_inter)
    wmf.train(max_iter=3, verbose=False)
    cer = JaxCER(k=6, d=cer_feat.shape[1], seed=3, mesh=_jax_mesh((2, 2)))
    cer.set_interactions(small_inter)
    cer.set_features(cer_feat)
    cer.train(max_iter=2, verbose=False)
    for r in port_als:
        for got, want in zip(r["wmf"], (wmf.fue, wmf.fie)):
            _close(got, want)
        for got, want in zip(r["cer"], (cer.fue, cer.fie, cer.E)):
            _close(got, want)


def test_dpm_with_a_mesh_equals_local(port_als):
    """DPM (dpm.py:44-46, 86-87) passes its mesh to the encoder it builds,
    which then fits data-parallel; two iterations with the 2x2 mesh equal
    two without one (lu = 1, as tests/test_torch_dpm.py holds DPM)."""
    for r in port_als:
        *mesh_tables, mesh_encoder = r["dpm"]["mesh"]
        *local_tables, local_encoder = r["dpm"]["local"]
        assert mesh_encoder and not local_encoder
        for got, want in zip(mesh_tables, local_tables):
            _close(got, want)


def test_data_parallel_encoder_fit_equals_local(port_als):
    """One data-parallel sweep (each minibatch split over dp = 2, the
    gradients summed) equals the single-device sweep of the port and of
    JAX from the same weights and shuffle, and every replica holds the same
    weights, bit for bit."""
    X, Y = _encoder_data()
    jenc = JaxMLP(**ENC)
    local = MLPEncoder(**ENC, device="cpu")
    local.load_state_dict(jenc.state_dict())
    want = local.fit(X, Y)
    j_loss = jenc.fit(X, Y)
    loss, state = port_als[0]["encoder"]
    for r in port_als[1:]:
        assert r["encoder"][0] == loss
        for n, a in r["encoder"][1].items():
            np.testing.assert_array_equal(a, state[n], err_msg=n)
    np.testing.assert_allclose(loss, want, rtol=1e-5)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-4)
    ref = local.state_dict()
    for n, a in jenc.state_dict().items():
        np.testing.assert_allclose(state[n], ref[n], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref[n]).max()),
                                   err_msg=n)
        np.testing.assert_allclose(state[n], a, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(a).max()),
                                   err_msg=n)


# ---------------------------------------------------------------------------
# sharded serving, the 2-D scoring grid
# ---------------------------------------------------------------------------

SERVE_K = 10


def _bf16(a):
    """Tables whose entries bf16 holds exactly: the servers round their
    inputs to bf16, and the CPU's XLA does not."""
    return a.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.fixture(scope="module")
def serve_inputs(small_inter):
    rng = np.random.default_rng(0)
    U = _bf16(rng.normal(size=(small_inter.n_users, 8)))
    V = _bf16(rng.normal(size=(small_inter.n_items, 8)))
    b = rng.normal(size=small_inter.n_items).astype(np.float32)
    users = np.array([0, 3, 5, 17, 21, 44, 44, 9, 119, 60, 61])
    # eight distinct users of the first shard: a sticky capacity of 1
    # overflows, and so does 2
    forced = np.array([3, 1, 7, 5, 11, 13, 2, 8])
    return U, V, b, users, forced


@pytest.fixture(scope="module")
def port_serving(small_inter, serve_inputs, tmp_path_factory):
    return spawn(serving_body, 4, tmp_path_factory.mktemp("serving"), (2, 2),
                 _arrays(small_inter), *serve_inputs, SERVE_K)


def _same(got, want):
    gv, gi = got
    wv, wi = (np.asarray(x) for x in want)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(gi[fin], wi[fin])


@pytest.mark.parametrize("seen_format", ["bitmap", "lists"])
def test_sharded_server_equals_jax(port_serving, small_inter, serve_inputs,
                                   seen_format):
    """``TopKServer(mesh=)`` with ``exact`` (U and the seen store sharded
    over mp = 2) returns JAX's mesh server's lists on every rank, and a
    batch served from a sticky capacity of 1 tries JAX's sequence of
    doubled capacities and ends with JAX's lists."""
    U, V, b, users, forced = serve_inputs
    srv = JaxServer(U, V, b, small_inter, mesh=_jax_mesh((2, 2)),
                    seen_format=seen_format)
    want = srv.recommend(users, k=SERVE_K, method="exact")
    tried = []
    ask = srv.recommend_async

    def logged(*a, **kw):
        tried.append(srv._lookup_capacity)
        return ask(*a, **kw)

    srv.recommend_async = logged
    srv._lookup_capacity = 1
    want_forced = srv.recommend(forced, k=SERVE_K, method="exact")
    assert len(tried) > 2
    for r in port_serving:
        _same(r[seen_format], want)
        got, got_tried, cap = r[seen_format + "_forced"]
        assert got_tried == tried
        assert cap == srv._lookup_capacity
        _same(got, want_forced)


def test_distributed_scores_topk_equals_jax(port_serving, serve_inputs):
    """tests/test_parallel.py:58: the [users/dp, items/mp] tiles, gathered
    along mp, then top-k in ``lax.top_k`` order and gathered along dp."""
    U, V, b, _, _ = serve_inputs
    want_vals, want_idx = jax_scores_topk(_jax_mesh((2, 2)), U, V, b,
                                          k=SERVE_K)
    for r in port_serving:
        vals, idx = r["scores"]
        np.testing.assert_allclose(vals, want_vals, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(idx, want_idx)
