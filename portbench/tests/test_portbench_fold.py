"""The seeded fold: same seed, same bytes; the reference's formats; the
counts the configuration asks for."""

import filecmp
import os

import numpy as np

from portbench.harness.fold import (make_features, make_fold, round6,
                                    user_counts, write_dat, write_fold_text)

CFG = {"n_users": 800, "n_items": 300, "n_om_items": 59, "n_pairs": 30000,
       "zipf_exponent": 1.1, "min_user_pairs": 20, "max_user_pairs": 200,
       "user_activity_sigma": 1.2, "im_holdout": 5, "d": 500,
       "topic_words": 200, "noise_words": 40}
SEED = 2**31 + 12345  # beyond 32 signed bits: seeds may be that large


def test_same_seed_same_bytes(tmp_path):
    for d in ("a", "b"):
        write_fold_text(make_fold(CFG, SEED, "cpu"), str(tmp_path / d))
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == ["f0te.im.idl", "f0te.im.txt", "f0te.om.idl",
                     "f0te.om.txt", "f0tr.txt", "uid", "vid"]
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / "a", tmp_path / "b",
                                               names, shallow=False)
    assert match == names and not mismatch and not errors
    other = make_fold(CFG, SEED + 1, "cpu")
    assert not np.array_equal(other.train_i,
                              make_fold(CFG, SEED, "cpu").train_i)


def test_counts():
    counts = user_counts(CFG, SEED)
    assert counts.sum() == CFG["n_pairs"]
    assert counts.min() >= 20 and counts.max() <= 200
    f = make_fold(CFG, SEED, "cpu")
    assert f.train_u.size + f.im_u.size + f.om_u.size == CFG["n_pairs"]
    assert f.om_items.size == 59 and f.im_items.size == 241
    assert np.union1d(f.im_items, f.om_items).size == 300
    assert np.isin(f.om_i, f.om_items).all()
    assert np.isin(f.train_i, f.im_items).all()
    assert np.isin(f.im_i, f.im_items).all()
    # one in five of each user's in-matrix pairs is held out
    n_im = np.bincount(np.concatenate([f.train_u, f.im_u]), minlength=800)
    assert np.array_equal(np.bincount(f.im_u, minlength=800), n_im // 5)
    # the out-of-matrix items hold about a fifth of the pairs
    assert 0.1 < f.om_u.size / CFG["n_pairs"] < 0.3
    keys = np.concatenate([u * 300 + i for u, i in (
        (f.train_u, f.train_i), (f.im_u, f.im_i), (f.om_u, f.om_i))])
    assert np.unique(keys).size == keys.size
    assert np.all(np.diff(f.train_u * 300 + f.train_i) > 0)


def test_reference_formats(tmp_path):
    f = make_fold(CFG, SEED, "cpu")
    write_fold_text(f, str(tmp_path))
    uid = (tmp_path / "uid").read_text().split("\n")
    assert uid[:2] == ["u0", "u1"] and len(uid) == 801 and uid[-1] == ""
    lines = (tmp_path / "f0tr.txt").read_text().splitlines()
    pairs = set()
    for ln in lines:
        terms = ln.split(",")
        assert terms[0].startswith("u") and len(terms) > 1
        for t in terms[1:]:
            iid, like = t.split(":")
            assert like == "1" and iid.startswith("i")
            pairs.add((int(terms[0][1:]), int(iid[1:])))
    assert pairs == set(zip(f.train_u.tolist(), f.train_i.tolist()))
    idl = (tmp_path / "f0te.om.idl").read_text().split()
    assert [int(x[1:]) for x in idl] == f.om_items.tolist()
    mat = round6(np.random.default_rng(0).normal(size=(3, 4)))
    write_dat(str(tmp_path / "t.dat"), mat)
    text = (tmp_path / "t.dat").read_text()
    assert text.endswith(" \n") and len(text.splitlines()) == 3
    back = np.array(text.split(), dtype=np.float32).reshape(3, 4)
    assert np.array_equal(back, mat)


def test_features():
    a = make_features(CFG, SEED, "cpu")
    b = make_features(CFG, SEED, "cpu")
    assert a.shape == (300, 500) and bool((a == b).all())
    assert bool((a.sum(1) == 240).all())
