"""The program's spans read out of a trace (``harness/spans.py``) and the
per-layer metrics that read them, on synthetic traces: counts, inclusive
and self time, idle gaps divided among the spans that ran during them,
and nothing read from a program without spans."""

import pytest

from portbench.harness import manifest, spans
from portbench.harness.trace import Trace

NEW = {"train": ["train_sample_us_per_step", "train_syncs_per_chunk",
                 "train_step_host_us", "train_grad_us_per_step"],
       "serve": ["serve_submit_us_per_batch", "serve_k1_host_us_per_batch",
                 "serve_fetch_us_per_batch"],
       "evaluate": ["eval_count_hits_s", "eval_fetch_s", "eval_read_dat_s"]}


def read(name, trace):
    return manifest.reader(name)(trace)


def host(*events):
    """``tkr.``-named host events from (name, start, end)."""
    return [("tkr." + n, s, e - s) for n, s, e in events]


def train_trace():
    """One chunk [0, 10]: the sampler [0, 2] with three syncs, two steps
    [3, 6] and [6, 9], each with its autograd span; torch ops besides."""
    return Trace("train", 10.0, [("k", 0.5, 0.1)],
                 host(("train.chunk", 0, 10), ("train.sample", 0, 2),
                      ("train.sync", 0.5, 0.6), ("train.sync", 1.0, 1.2),
                      ("train.sync", 1.5, 1.6), ("train.step", 3, 6),
                      ("train.grad", 4, 5), ("train.step", 6, 9),
                      ("train.grad", 7, 8.5))
                 + [("aten::mul", 4.1, 0.2), ("cudaLaunchKernel", 7.0, 0.1)],
                 counts={"steps": 2})


def test_counts_inclusive_and_self():
    t = train_trace()
    assert [n for n, _, _ in spans.spans(t)][:3] == [
        "train.chunk", "train.sample", "train.sync"]
    assert spans.count(t, "train.sync") == 3
    assert spans.count(t, "aten::mul") == 0
    assert spans.inclusive_s(t, "train.chunk") == 10
    assert spans.inclusive_s(t, "train.step") == 6
    # the chunk less its sampler and steps; the sampler less its syncs;
    # each step less its autograd span
    assert spans.self_s(t, "train.chunk") == pytest.approx(2.0)
    assert spans.self_s(t, "train.sample") == pytest.approx(1.6)
    assert spans.self_s(t, "train.step") == pytest.approx(3.5)
    assert spans.self_s(t, "train.grad") == pytest.approx(2.5)


def test_train_readers():
    t = train_trace()
    assert read("train_sample_us_per_step", t) == pytest.approx(1e6)
    assert read("train_syncs_per_chunk", t) == 3.0
    assert read("train_step_host_us", t) == pytest.approx(3e6)
    assert read("train_grad_us_per_step", t) == pytest.approx(1.25e6)


def test_serve_readers():
    batches = [host(("serve.recommend", b, b + 1.0),
                    ("serve.submit", b, b + 0.5),
                    ("k1.launch", b + 0.2, b + 0.3),
                    ("serve.fetch", b + 0.5, b + 0.9)) for b in (0, 2)]
    t = Trace("serve", 3.0, [], batches[0] + batches[1],
              counts={"batches": 2})
    assert read("serve_submit_us_per_batch", t) == pytest.approx(5e5)
    assert read("serve_k1_host_us_per_batch", t) == pytest.approx(1e5)
    assert read("serve_fetch_us_per_batch", t) == pytest.approx(4e5)
    assert spans.self_s(t, "serve.recommend") == pytest.approx(0.2)


def test_evaluate_readers():
    t = Trace("evaluate", 9.0, [],
              host(("evaluate.dat_parse", 0, 2), ("io.read_dat", 0, 0.75),
                   ("io.read_dat", 1, 1.5), ("evaluate.im_eval", 2, 8),
                   ("eval.fetch", 3, 4), ("eval.count_hits", 4, 7),
                   ("eval.like_bitmap", 4.5, 6.5)),
              counts={"folds": 1})
    assert read("eval_read_dat_s", t) == pytest.approx(1.25)
    assert read("eval_fetch_s", t) == pytest.approx(1.0)
    assert read("eval_count_hits_s", t) == pytest.approx(3.0)


@pytest.mark.parametrize("kind", sorted(NEW))
def test_nothing_read_without_spans(kind):
    """The program before its spans: torch ops only, so every new reader
    returns None, and a trace of another kind reads nothing either."""
    t = Trace(kind, 1.0, [("k", 0.0, 0.1)], [("aten::add", 0.0, 0.5)],
              counts={"steps": 128, "batches": 200, "folds": 1})
    other = Trace("other", 1.0, [], host(("train.chunk", 0, 1)))
    for name in NEW[kind]:
        assert read(name, t) is None, name
        assert read(name, other) is None, name
        assert read(name, None) is None, name


def test_idle_by_span_divides_a_gap_by_overlap():
    """One gap [1, 5] under a parent span [0, 6] with two children: each
    piece goes to the innermost span running then."""
    t = Trace("train", 6.0, [("a", 0.0, 1.0), ("b", 5.0, 1.0)],
              host(("p", 0, 6), ("x", 0.5, 3), ("y", 3.5, 4.5)))
    assert spans.idle_gaps(t) == [(1.0, 5.0)]
    got = spans.idle_by_span(t)
    assert got == pytest.approx({"x": 2.0, "p": 1.0, "y": 1.0})
    assert sum(got.values()) == pytest.approx(4.0)


def test_idle_outside_every_span():
    t = Trace("serve", 6.0, [("a", 0.0, 1.0), ("b", 4.0, 1.0)],
              host(("s", 1.5, 2.5)))
    assert spans.idle_by_span(t) == pytest.approx(
        {spans.OUTSIDE: 2.0, "s": 1.0})
    assert spans.idle_by_span(Trace("serve", 1.0, [], [])) == {}


def test_the_gap_goes_to_the_spans_not_to_the_call_at_its_end():
    """A 3.9-s gap ends inside a ``cudaStreamSynchronize`` that an
    ``eval.fetch`` span holds, after an ``eval.count_hits`` span: the
    breakdown charges the call the gap ended in, ``idle_by_span`` the
    spans that ran during it."""
    dev = [("topk_merge", 0.5, 0.5), ("Memcpy DtoH", 4.9, 0.01)]
    hst = (host(("eval.count_hits", 1.0, 3.0),
                ("eval.like_bitmap", 1.2, 2.9),
                ("io.test_likes", 3.0, 3.8), ("eval.fetch", 3.8, 4.95))
           + [("cudaStreamSynchronize", 3.85, 1.1)])
    t = Trace("evaluate", 5.0, dev, hst)
    gaps = dict(t.breakdown()["idle_gaps"])
    assert gaps == pytest.approx({"cudaStreamSynchronize": 3.9})
    got = spans.idle_by_span(t)
    assert got == pytest.approx({"eval.like_bitmap": 1.7,
                                 "io.test_likes": 0.8, "eval.fetch": 1.1,
                                 "eval.count_hits": 0.3})
    assert sum(got.values()) == pytest.approx(3.9)


def test_the_new_metrics_are_listed_for_their_cells():
    man = manifest.load()
    cell = {"train": "bpr-ml10m.train-b256", "serve": "bpr-ml10m.serve-b256",
            "evaluate": "bpr-ml10m.evaluate"}
    for kind, names in NEW.items():
        listed = {m["name"]: m for m in manifest.per_layer(man, cell[kind])}
        for name in names:
            assert listed[name]["source"] == "program_span"
    assert "eval_parse_s" in {m["name"] for m in manifest.per_layer(
        man, cell["evaluate"])}
