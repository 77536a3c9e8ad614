"""The port's ``load_test_likes`` against the JAX package's, which is its
specification, under both of the port's parsers: the same dict, keys in
the same order, the same list of ints per key, on every rule the spec
applies. The C++ parser leaves files whose text-mode reading it does not
copy to the Python loop, which opens one ``io.test_likes_python`` span a
file."""

import numpy as np
import pytest

from test_torch_data import parser  # noqa: F401  (a fixture)
from topk_rec_torch import tracing
from topk_rec_torch.eval.protocol import load_test_likes
from topk_rec_tpu.eval.protocol import load_test_likes as spec_likes

UIDS = {"u1": 10, "u2": 20, "u3": 30, "u4": 40, "u5": 50, "u6": 60,
        "u7": 70, "u2b": 20}  # not dense; u2b is u2's value again
CANDS = {"i1": 3, "i2": 1, "i3": 7}

RULES = (
    b"  u1,i1:1,i2:1,i9:1,i1:1,i3:0\r\n"   # leading spaces; CRLF; dup kept
    b"u2\n"                                # bare known user
    b"u3,i1:0,i2:0\r\n"                    # only :0 terms
    b"stranger,i1:1\n"                     # unknown user
    b"\n"                                  # blank line
    b"u4,i2:10,i2:1:1,i2:,i2,i2:1 \n"      # only the last term is a like
    b"u5, i2:1,i1:1\n"                     # inner space kept: " i2" no item
    b"u1,i3:1\n"                           # replaces u1's list, keeps place
    b"u6 ,i1:1\n"                          # "u6 " is no user
    b"u2b,i1:1,i1:1\n"                     # u2's value: replaces its list
    b"\t u7,i3:1,i1:1\t"                   # no final newline
)
RULES_WANT = {10: [7], 20: [3, 3], 30: [], 40: [1], 50: [3], 70: [7, 3]}


def _write(tmp_path, data: bytes, name="te.txt") -> str:
    path = tmp_path / name
    path.write_bytes(data)
    return str(path)


def _likes(path, uids, cands):
    """The port's dict and the ``io.test_likes_python`` spans it opened."""
    with tracing.recording() as rec:
        got = load_test_likes(path, uids, cands)
    return got, sum(name == "io.test_likes_python" for name, _ in rec)


def _assert_spec(got, path, uids, cands):
    want = spec_likes(path, uids, cands)
    assert list(got.items()) == list(want.items())
    assert all(type(u) is int for u in got)
    assert all(type(v) is list and all(type(i) is int for i in v)
               for v in got.values())


@pytest.mark.parametrize("extra", [{}, {"": 99, "u9\nu1": 98}],
                         ids=["ids", "empty-and-newline-ids"])
def test_rules_match_spec(tmp_path, parser, extra):
    path = _write(tmp_path, RULES)
    uids = {**UIDS, **extra}
    got, _ = _likes(path, uids, CANDS)
    _assert_spec(got, path, uids, CANDS)
    if not extra:
        assert list(got.items()) == list(RULES_WANT.items())
    else:  # the blank line is the empty id's, after u3's line
        assert list(got)[3] == 99 and got[99] == []


def _random_file(rng, uids, cands) -> bytes:
    """Lines of known and unknown users, repeated, with terms of known and
    unknown items liked 1, 0 or otherwise, blank lines, CRLF endings and
    whitespace at the ends."""
    users = list(uids) + [f"nouser{n}" for n in range(5)]
    items = list(cands) + [f"noitem{n}" for n in range(5)]
    likes = ["1", "1", "1", "0", "10", "", "1:1", "01"]
    lines = []
    for _ in range(int(rng.integers(20, 80))):
        if rng.random() < 0.05:
            lines.append("")
            continue
        terms = [users[int(rng.integers(len(users)))]]
        for _ in range(int(rng.integers(0, 12))):
            term = items[int(rng.integers(len(items)))]
            if rng.random() < 0.9:
                term += ":" + likes[int(rng.integers(len(likes)))]
            terms.append(term)
        line = ",".join(terms)
        if rng.random() < 0.2:
            line = " " * int(rng.integers(1, 3)) + line
        if rng.random() < 0.2:
            line += "\t "[int(rng.integers(2))]
        lines.append(line)
    ends = [("\r\n" if rng.random() < 0.3 else "\n") for _ in lines]
    text = "".join(line + end for line, end in zip(lines, ends))
    if rng.random() < 0.5:
        text = text.rstrip("\r\n")
    return text.encode()


@pytest.mark.parametrize("seed", range(6))
def test_random_files_match_spec(tmp_path, parser, seed):
    rng = np.random.default_rng(seed)
    uids = {f"user{n}": int(v) for n, v in
            enumerate(rng.permutation(40)[:30])}
    uids["alias"] = uids["user0"]
    cands = {f"it{n}": int(v) for n, v in
             enumerate(rng.permutation(60)[:25])}
    path = _write(tmp_path, _random_file(rng, uids, cands))
    got, _ = _likes(path, uids, cands)
    _assert_spec(got, path, uids, cands)


@pytest.mark.parametrize("data", [
    "u1,i1:1\nü1,i2:1\nu2,i3:1\n".encode(),   # non-ASCII id
    b"u1,i1:1\ru2,i2:1\nu3,i3:1\n",           # lone \r: a line break
    b"u1,i1:1\x0c\nu2,i2:1\n",                # \f: whitespace to strip
    b"u1,i1:1\x0b\nu2,i2:1\n",                # \v: the same
    b"u1,i1:1\nu2,i2:1\x1f\n",                # \x1f: the same
], ids=["non-ascii", "lone-cr", "form-feed", "vtab", "unit-separator"])
def test_unhandled_bytes_fall_back(tmp_path, parser, data):
    uids = {**UIDS, "ü1": 80}
    path = _write(tmp_path, data)
    got, python_spans = _likes(path, uids, CANDS)
    _assert_spec(got, path, uids, CANDS)
    assert python_spans == 1


def test_benchmark_format_stays_native(tmp_path, parser):
    rng = np.random.default_rng(3)
    uids = {f"u{n}": n for n in range(50)}
    cands = {f"i{n}": k for k, n in enumerate(range(0, 200, 3))}
    lines = [",".join([f"u{u}"] + [f"i{i}:1" for i in
                                   rng.integers(0, 200, size=6)])
             for u in range(50)]
    path = _write(tmp_path, ("\n".join(lines) + "\n").encode())
    got, python_spans = _likes(path, uids, cands)
    _assert_spec(got, path, uids, cands)
    assert python_spans == (0 if parser == "native" else 1)


def test_invalid_utf8_raises(tmp_path, parser):
    path = _write(tmp_path, b"u1,i1:1\nu2,i\xff:1\n")
    with pytest.raises(UnicodeDecodeError):
        spec_likes(path, UIDS, CANDS)
    with pytest.raises(UnicodeDecodeError):
        load_test_likes(path, UIDS, CANDS)
