"""The port's own data, config and utils modules against the JAX
package's: the same fold, ``.dat`` tables and feature pickle, read by both,
give equal arrays and layouts, and both write the same bytes. Both of the
port's parsers are held: the C++ one (built with g++ at first use) and the
Python one."""

import dataclasses
import os
import pickle
from datetime import datetime

import numpy as np
import pytest
import scipy.sparse as ss

from topk_rec_torch import config as tcfg
from topk_rec_torch.data import dataset as tds
from topk_rec_torch.data import io as tio
from topk_rec_torch.native import io_native as tnat
from topk_rec_torch.tools import text as ttext
from topk_rec_torch.utils import logging as tlog
from topk_rec_torch.utils import statelog as tstate
from topk_rec_tpu import config as jcfg
from topk_rec_tpu.data import dataset as jds
from topk_rec_tpu.data import io as jio
from topk_rec_tpu.tools import text as jtext
from topk_rec_tpu.utils import logging as jlog
from topk_rec_tpu.utils import statelog as jstate


@pytest.fixture(params=["native", "python"])
def parser(request, monkeypatch):
    """The port's parser under test; the other is switched off."""
    if request.param == "native":
        if not tnat.available():
            pytest.skip("no host C++ compiler to build the port's parser")
        monkeypatch.setattr(tio, "_native_lib", lambda: tnat)
    else:
        monkeypatch.setattr(tio, "_native_lib", lambda: None)
    return request.param


def write_fold(root, seed=0, n_users=40, n_items=70):
    """uid / vid / f0tr.txt in the reference formats: string ids that are
    not their indices, likes 0 and 1, an unknown item, an unknown user, a
    user line with no items and repeated mentions."""
    rng = np.random.default_rng(seed)
    uids = [f"user{(i * 7) % n_users}x" for i in range(n_users)]
    iids = [f"it{(i * 11) % n_items}_{i}" for i in range(n_items)]
    with open(os.path.join(root, "uid"), "w") as f:
        f.write("\n".join(uids) + "\n")
    with open(os.path.join(root, "vid"), "w") as f:
        f.write("\n".join(iids) + "\n")
    lines = []
    for u in range(n_users):
        n = int(rng.integers(0, 9))
        cells = [f"{iids[int(i)]}:{int(rng.integers(0, 2))}"
                 for i in rng.integers(0, n_items, size=n)]
        if u % 5 == 0:
            cells.append("nosuchitem:1")
        lines.append(",".join([uids[u]] + cells))
    lines.append("nosuchuser,%s:1" % iids[0])
    with open(os.path.join(root, "f0tr.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return [os.path.join(root, n) for n in ("uid", "vid", "f0tr.txt")]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_parses_equal(tmp_path, parser, seed):
    uid, vid, tr = write_fold(str(tmp_path), seed)
    got, gu, gi = tds.Interactions.from_files(uid, vid, tr)
    want, wu, wi = jds.Interactions.from_files(uid, vid, tr)
    assert gu == wu and gi == wi
    assert (got.n_users, got.n_items, got.nnz) == (
        want.n_users, want.n_items, want.nnz)
    for name in ("pos_u", "pos_i", "seen_u", "seen_i", "user_deg",
                 "item_deg", "rated_users", "rated_items", "pos_bitmap",
                 "seen_bitmap", "item_like_counts"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    for name in ("user_csr", "item_csr"):
        for g, w in zip(getattr(got, name), getattr(want, name)):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert np.array_equal(got.user_indptr, want.user_indptr)


def test_parse_ratings_equal(tmp_path, parser):
    uid, vid, tr = write_fold(str(tmp_path), 3)
    uids, iids = tio.load_id_map(uid), tio.load_id_map(vid)
    assert uids == jio.load_id_map(uid) and iids == jio.load_id_map(vid)
    for g, w in zip(tio.parse_ratings(tr, uids, iids),
                    jio.parse_ratings(tr, uids, iids)):
        assert g.dtype == np.int32 and np.array_equal(g, w)


@pytest.mark.parametrize("shape", [(5, 3), (1, 1), (17, 50), (4,)])
def test_write_dat_bytes_and_read_back(tmp_path, parser, shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[0])
    mat = (rng.normal(size=shape) * 10).astype(np.float32)
    mat.flat[0] = -0.0
    ours, theirs = tmp_path / "ours" / "m.dat", tmp_path / "theirs.dat"
    tio.write_dat(str(ours), mat)
    jio.write_dat(str(theirs), mat)
    assert ours.read_bytes() == theirs.read_bytes()
    got = tio.read_dat(str(ours))
    assert np.array_equal(got, jio.read_dat(str(theirs)))
    assert got.dtype == np.float32 and got.shape == mat.reshape(
        mat.shape[0], -1).shape


def test_read_dat_errors_match(tmp_path, parser):
    ragged = tmp_path / "ragged.dat"
    ragged.write_text("1.0 2.0 \n3.0 \n")
    text = tmp_path / "text.dat"
    text.write_text("1.0 abc \n")
    empty = tmp_path / "empty.dat"
    empty.write_text("\n\n")
    for path in (ragged, text):
        with pytest.raises(ValueError, match="malformed .dat"):
            tio.read_dat(str(path))
    assert tio.read_dat(str(empty)).shape == (0, 0)
    ids = {"a": 0, "b": 1, "c": 2}
    ok = tmp_path / "ok.dat"
    ok.write_text("1.0 \n2.0 \n")
    with pytest.raises(ValueError, match="expected 3 rows"):
        tio.read_dat(str(ok), ids)


@pytest.mark.parametrize("sparse", [True, False])
def test_load_features_equal(tmp_path, sparse):
    rng = np.random.default_rng(5)
    feat_ids = [f"f{i}" for i in range(12)]
    feat = (rng.random((12, 9)) < 0.3) * rng.integers(1, 5, (12, 9))
    payload = ss.csr_matrix(feat.astype(np.float64)) if sparse else feat
    pkl = tmp_path / "meta.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(payload, f, protocol=2)
    idl = tmp_path / "feat.idl"
    idl.write_text("\n".join(feat_ids) + "\n")
    item_ids = {f"f{i}": j for j, i in enumerate([3, 0, 11, 7])}
    item_ids["missing"] = 4
    for d in (None, 9):
        got = tio.load_features(str(pkl), str(idl), item_ids, d=d)
        want = jio.load_features(str(pkl), str(idl), item_ids, d=d)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not got[4].any()


@pytest.mark.parametrize("name", ["DataConfig", "ModelConfig", "TrainConfig",
                                  "EvalConfig"])
def test_config_defaults_equal(name):
    ours, theirs = getattr(tcfg, name)(), getattr(jcfg, name)()
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    if name == "DataConfig":
        assert ours.train_file == theirs.train_file == "f0tr.txt"


class _FixedNow(datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime(2024, 2, 29, 13, 5, 7, 123456)


@pytest.mark.parametrize("msg", ["Loading finished!", "Epoch  3, loss 0.5",
                                 ""])
def test_tprint_bytes_equal(monkeypatch, capsys, tmp_path, msg):
    monkeypatch.setattr(tlog, "datetime", _FixedNow)
    monkeypatch.setattr(jlog, "datetime", _FixedNow)
    tlog.tprint(msg)
    ours = capsys.readouterr().out
    jlog.tprint(msg)
    assert ours == capsys.readouterr().out
    assert ours == f"2024-02-29 13:05:07.123456: {msg}\n"
    paths = tmp_path / "a.txt", tmp_path / "b.txt"
    for mod, path in zip((tlog, jlog), paths):
        with open(path, "w") as f:
            mod.tprint(msg, file=f)
    assert paths[0].read_bytes() == paths[1].read_bytes()


def test_statelog_bytes_equal(monkeypatch, tmp_path):
    settings = {"k": 50, "lambda_u": 0.01, "model": "cer", "tol": 1e-4}
    dirs = []
    for mod in (tstate, jstate):
        clock = iter([100.0, 101.25, 103.5, 110.0])
        monkeypatch.setattr(mod.time, "time", lambda: next(clock))
        d = tmp_path / mod.__name__.split(".")[0]
        log = mod.StateLog(str(d), settings)
        log.append(1, -1234.5678, 0.25)
        log.append(2, -1000.0, 1.5e-5)
        log.append(12, float("nan"), 0.0)
        dirs.append(d)
    for name in ("settings.txt", "state.log"):
        assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes()
    assert tstate.StateLog(None, settings).path is None


def test_parser_reports_native_when_built(monkeypatch):
    monkeypatch.setattr(tio, "_NATIVE_CHECKED", False)
    monkeypatch.setattr(tio, "_NATIVE", None)
    want = "native" if tnat.available() else "python"
    assert tio.parser() == want
    monkeypatch.setattr(tio, "_native_lib", lambda: None)
    assert tio.parser() == "python"


def test_data_api_lists_the_jax_names():
    import topk_rec_torch.data as tdata
    import topk_rec_tpu.data as jdata

    assert set(jdata.__all__) <= set(tdata.__all__)
    assert set(tdata.__all__) - set(jdata.__all__) == {"parser", "read_mfp",
                                                       "write_mfp"}
    for name in tdata.__all__:
        assert callable(getattr(tdata, name)), name


@pytest.mark.parametrize("args", [(40, 30, 500, 0), (70, 25, 900, 3, 4, 0.2)])
def test_synthetic_interactions_equal(args):
    got, want = tds.synthetic_interactions(*args), \
        jds.synthetic_interactions(*args)
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
    for name in ("pos_u", "pos_i", "seen_u", "seen_i"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    for key in ("u_lat", "i_lat"):
        assert np.array_equal(got._cache[key], want._cache[key]), key
    dense = got.dense_matrix()
    assert dense.dtype == np.float32 and dense.sum() == got.nnz
    assert np.array_equal(dense, want.dense_matrix())
    assert np.array_equal(got.dense_matrix(np.int8),
                          want.dense_matrix(np.int8))


def test_synthetic_features_equal():
    got_i, want_i = tds.synthetic_interactions(30, 20, 200, seed=5), \
        jds.synthetic_interactions(30, 20, 200, seed=5)
    for d, seed in ((7, 0), (12, 4)):
        g = tds.synthetic_features(got_i, d, seed=seed)
        w = jds.synthetic_features(want_i, d, seed=seed)
        assert g.dtype == np.float32 and np.array_equal(g, w)
    # without the generating latents: the co-occurrence mix
    plain = [m.Interactions(30, 20, want_i.pos_u, want_i.pos_i)
             for m in (tds, jds)]
    g = tds.synthetic_features(plain[0], 9, seed=2, noise=0.1)
    w = jds.synthetic_features(plain[1], 9, seed=2, noise=0.1)
    assert g.dtype == np.float32 and np.array_equal(g, w)


def test_inverse_id_map_and_mfp_equal(tmp_path):
    uid, _, _ = write_fold(str(tmp_path), 4)
    assert tio.load_inverse_id_map(uid) == jio.load_inverse_id_map(uid)
    inv = tio.load_inverse_id_map(uid)
    assert {v: k for k, v in inv.items()} == tio.load_id_map(uid)
    rng = np.random.default_rng(6)
    deg = rng.integers(0, 6, size=9)
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    flat = rng.integers(0, 1000, size=int(indptr[-1])).astype(np.int32)
    ours, theirs = tmp_path / "a.mfp", tmp_path / "b.mfp"
    tio.write_mfp(str(ours), indptr, flat)
    jio.write_mfp(str(theirs), indptr, flat)
    assert ours.read_bytes() == theirs.read_bytes()
    with open(ours, "a") as f:
        f.write("\n")  # blank lines are skipped
    for g, w, a in zip(tio.read_mfp(str(ours)), jio.read_mfp(str(theirs)),
                       (indptr, flat)):
        assert g.dtype == np.int32 and np.array_equal(g, w)
        assert np.array_equal(g, a)


def test_tfidf_features_equal():
    docs = ["The cat sat on the mat.", "the dog chased THE cat", "",
            "quantum chromodynamics: lattice gauge theory, gauge fields",
            "cat cat cat dog"]
    for vocab_size, lowercase in ((8, True), (3, True), (50, False)):
        g, gv = ttext.tfidf_features(docs, vocab_size, lowercase)
        w, wv = jtext.tfidf_features(docs, vocab_size, lowercase)
        assert gv == wv
        assert g.dtype == np.float32 and np.array_equal(g, w)


def test_lda_topics_equal():
    counts = np.random.default_rng(1).integers(0, 4, size=(15, 12))
    for g, w in zip(ttext.lda_topics(counts, n_topics=3, max_iter=4, seed=2),
                    jtext.lda_topics(counts, n_topics=3, max_iter=4, seed=2)):
        assert g.dtype == np.float32 and np.array_equal(g, w)
