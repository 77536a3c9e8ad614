"""The port's spans (``topk_rec_torch/tracing.py``): a shared no-op when
nothing traces, host events named ``tkr.<name>`` under ``torch.profiler``,
kept seconds under ``recording()``; where the trainer, the server and the
evaluator open them; and results bitwise equal with spans on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from topk_rec_torch import cli as torch_cli
from topk_rec_torch import tracing
from topk_rec_torch.data import (
    Interactions,
    synthetic_features,
    synthetic_interactions,
    write_dat,
)
from topk_rec_torch.models import BPR, VBPR
from topk_rec_torch.models.bpr import INIT_STREAM, stream_generator
from topk_rec_torch.ops import sampling
from topk_rec_torch.serving import TopKServer
from topk_rec_torch.tracing import recording, span

STEPS, BATCH = 3, 16


def traced(fn):
    """(fn's result, its spans as (name, start, end) under a CPU
    profiler, in the order they started)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name[len(tracing.PREFIX):], e.time_range.start,
                     e.time_range.end) for e in prof.events()
                    if e.name.startswith(tracing.PREFIX)),
                   key=lambda s: (s[1], -s[2]))
    return out, spans


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def each_inside(spans, child, *parents):
    """Every ``child`` span lies inside a span named one of ``parents``,
    and there is at least one."""
    kids = named(spans, child)
    outer = [s for s in spans if s[0] in parents]
    return bool(kids) and all(any(inside(c, p) for p in outer) for c in kids)


def test_off_is_one_shared_no_op():
    assert not torch.autograd._profiler_enabled()
    a, b = span("train.step"), span("serve.fetch")
    assert a is b
    with a as entered:
        assert entered is a
    with recording() as rec:
        pass
    with span("io.fold"):
        pass
    assert rec == [] and tracing._recordings == []


def test_recording_keeps_spans_closed_inside_it():
    with span("outside"):
        with recording() as rec:
            assert span("x") is not span("y")
            with span("parent"):
                with span("child"):
                    sum(range(1000))
    assert [n for n, _ in rec] == ["child", "parent"]
    child, parent = (t for _, t in rec)
    assert 0 < child <= parent
    assert tracing._recordings == []


def test_nested_recordings_each_keep_their_spans():
    with recording() as outer:
        with recording() as inner:
            pass
        with span("after"):
            pass
    assert inner == [] and [n for n, _ in outer] == ["after"]


def test_a_span_is_a_host_event_under_the_profiler():
    def body():
        with span("parent"):
            with span("child"):
                torch.ones(4).add_(1)

    _, spans = traced(body)
    assert [s[0] for s in spans] == ["parent", "child"]
    assert inside(spans[1], spans[0])
    # the function scope: no user annotation, which the profiler would
    # project onto the card's timeline as a device record
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        body()
    ours = [e for e in prof.events() if e.name.startswith(tracing.PREFIX)]
    assert ours and not any(e.is_user_annotation for e in ours)
    assert all(e.device_type == torch.autograd.DeviceType.CPU for e in ours)


@pytest.fixture(scope="module")
def inter():
    return synthetic_interactions(60, 40, 900, seed=3)


def _model(kind, inter):
    if kind == "vbpr":
        m = VBPR(k=8, d=12, device="cpu")
        m.set_interactions(inter)
        m.set_features(synthetic_features(inter, d=12, seed=4))
    else:
        m = BPR(k=8, device="cpu")
        m.set_interactions(inter)
    m._init_params(stream_generator(0, INIT_STREAM, "cpu"))
    return m


def _chunk(m, kind):
    gen = stream_generator(5, 0, "cpu")
    if kind == "vbpr":
        return m.train_chunk(gen, STEPS, BATCH)
    return m.train_chunk(gen, STEPS, BATCH, fused=kind == "bpr-fused")


@pytest.mark.parametrize("kind", ["bpr", "bpr-fused", "vbpr"])
def test_train_chunk_spans(inter, kind):
    _, spans = traced(lambda: _chunk(_model(kind, inter), kind))
    chunk = named(spans, "train.chunk")
    assert len(chunk) == 1
    assert each_inside(spans, "train.sample", "train.chunk")
    assert each_inside(spans, "train.sync", "train.sample")
    steps = named(spans, "train.step")
    assert len(steps) == STEPS and all(inside(s, chunk[0]) for s in steps)
    grads = named(spans, "train.grad")
    assert len(grads) == STEPS
    assert all(inside(g, s) for g, s in zip(grads, steps))


@pytest.mark.parametrize("kind", ["bpr", "vbpr"])
def test_train_chunk_bitwise_equal_with_spans_on(inter, kind):
    plain, spanned = _model(kind, inter), _model(kind, inter)
    loss = _chunk(plain, kind)
    with recording():
        traced_loss, _ = traced(lambda: _chunk(spanned, kind))
    assert torch.equal(loss, traced_loss)
    for name, t in plain.tables.state_dict().items():
        assert torch.equal(t, spanned.tables.state_dict()[name]), name


def test_sync_spans_count_the_redraw_rounds():
    """One user likes 38 of 40 items, so most of its candidates are
    positives and the redraw loop runs many rounds: 1 + 3 per round."""
    rng = np.random.default_rng(8)
    dense = np.arange(38)
    users = np.concatenate([np.zeros(38, np.int64),
                            np.repeat(np.arange(1, 4), 3)])
    items = np.concatenate([dense, rng.choice(40, 9)])
    inter = Interactions(4, 40, users.astype(np.int32),
                         items.astype(np.int32))
    sampler = sampling.TripletSampler(inter, device="cpu")
    gen = torch.Generator().manual_seed(1)
    before = gen.get_state()
    drawn, spans = traced(lambda: sampler(gen, 64))
    # the same draws again, counting the probes: one for the candidates,
    # then one a round
    probes = []

    def probe(u, c):
        probes.append(1)
        return sampling._bitmap_probe(sampler.pos_bitmap, u, c)

    gen.set_state(before)
    again = sampling._sample(gen, sampler.user_rows, sampler.flat_pos, 64,
                             40, sampler.k_candidates, probe)
    rounds = len(probes) - 1
    assert rounds > 3
    assert len(named(spans, "train.sync")) == 1 + 3 * rounds
    assert all(torch.equal(a, b) for a, b in zip(drawn, again))


def test_recommend_spans_and_same_results(inter):
    rng = np.random.default_rng(2)
    U = rng.normal(size=(inter.n_users, 6)).astype(np.float32)
    V = rng.normal(size=(inter.n_items, 6)).astype(np.float32)
    b = rng.normal(size=inter.n_items).astype(np.float32)
    srv = TopKServer(U, V, b, inter, device="cpu")
    users = np.array([0, 7, 3, 59])
    want = srv.recommend(users, k=5, method="kernel")
    got, spans = traced(lambda: srv.recommend(users, k=5, method="kernel"))
    assert len(named(spans, "serve.recommend")) == 1
    assert each_inside(spans, "serve.submit", "serve.recommend")
    assert each_inside(spans, "serve.fetch", "serve.recommend")
    for w, g in zip(want, got):
        assert np.array_equal(w, g)


@pytest.fixture(scope="module")
def fold_dir(tmp_path_factory, inter):
    """The fold in the reference's files: string ids, im and om, and a
    model directory of tables."""
    root = tmp_path_factory.mktemp("tracing_fold")
    uid = [f"u{u}" for u in range(inter.n_users)]
    vid = [f"v{i}" for i in range(inter.n_items)]
    (root / "uid").write_text("\n".join(uid) + "\n")
    (root / "vid").write_text("\n".join(vid) + "\n")
    indptr, flat = inter.user_csr
    (root / "f0tr.txt").write_text("".join(
        ",".join([uid[u]] + [f"{vid[i]}:1" for i in
                             flat[indptr[u]:indptr[u + 1]]]) + "\n"
        for u in range(inter.n_users) if indptr[u + 1] > indptr[u]))
    rng = np.random.default_rng(4)
    for scen, cand in (("im", range(30)), ("om", range(30, 40))):
        cand = list(cand)
        (root / f"f0te.{scen}.idl").write_text(
            "\n".join(vid[i] for i in cand) + "\n")
        (root / f"f0te.{scen}.txt").write_text("".join(
            ",".join([uid[u]] + [f"{vid[i]}:1" for i in
                                 rng.choice(cand, 2, replace=False)]) + "\n"
            for u in range(0, inter.n_users, 2)))
    mdir = root / "model"
    mdir.mkdir()
    for name, n in (("U", inter.n_users), ("V", inter.n_items)):
        write_dat(str(mdir / f"final-{name}.dat"),
                  rng.normal(size=(n, 5)).astype(np.float32))
    return root


def _evaluate(fold_dir, capsys):
    assert torch_cli.main([
        "evaluate", "-d", str(fold_dir), "-m", str(fold_dir / "model"),
        "-f", "0", "-sl", "im", "om", "--device", "cpu"]) == 0
    return capsys.readouterr().out


def test_evaluate_spans_and_same_output(fold_dir, capsys):
    want = _evaluate(fold_dir, capsys)
    got, spans = traced(lambda: _evaluate(fold_dir, capsys))
    assert got == want and got.startswith("im,")
    phases = [s[0] for s in spans if s[0].startswith("evaluate.")]
    assert phases == ["evaluate.fold_parse", "evaluate.dat_parse",
                      "evaluate.im_inputs", "evaluate.im_eval",
                      "evaluate.om_inputs", "evaluate.om_eval"]
    assert each_inside(spans, "io.fold", "evaluate.fold_parse")
    assert len(named(spans, "io.read_dat")) == 2
    assert each_inside(spans, "io.read_dat", "evaluate.dat_parse")
    assert len(named(spans, "io.test_likes")) == 2
    assert each_inside(spans, "io.test_likes", "evaluate.im_inputs",
                       "evaluate.om_inputs")
    assert len(named(spans, "eval.count_hits")) == 2
    for child in ("eval.score", "eval.fetch", "eval.count_hits"):
        assert each_inside(spans, child, "evaluate.im_eval",
                           "evaluate.om_eval"), child
    assert each_inside(spans, "eval.like_bitmap", "eval.count_hits")


def _cer(inter, d, le=10e3):
    from topk_rec_torch.models import CER

    m = CER(k=6, d=d, le=le, seed=2, block_size=16, device="cpu")
    m.set_interactions(inter)
    m.set_features(synthetic_features(inter, d=d, seed=6))
    return m


def test_cer_train_spans(inter):
    """d > n_items: the Woodbury route on its Cholesky factor, three
    iterations."""
    m = _cer(inter, d=120)
    _, spans = traced(lambda: m.train(max_iter=3, tol=0.0, verbose=False))
    iters = named(spans, "cer.iter")
    assert len(iters) == 3
    for name in ("cer.features", "cer.gram", "cer.factor", "cer.writeback"):
        assert len(named(spans, name)) == 1, name
    assert not any(inside(s, it) for it in iters
                   for s in named(spans, "cer.features")
                   + named(spans, "cer.writeback"))
    esolves = named(spans, "cer.esolve")
    assert len(esolves) == 3 and all(inside(e, it)
                                     for e, it in zip(esolves, iters))
    assert inside(named(spans, "cer.gram")[0], esolves[0])
    # one factor a call, in the first E-solve's Gram; no iterative steps
    assert inside(named(spans, "cer.factor")[0], named(spans, "cer.gram")[0])
    assert named(spans, "cer.cg_step") == [] and m.e_solver_steps == 0
    assert named(spans, "cer.esolve_direct") == []
    assert each_inside(spans, "cer.loss", "cer.iter")
    sweeps = named(spans, "als.half_sweep")
    assert len(sweeps) == 6 and each_inside(spans, "als.half_sweep",
                                            "cer.iter")
    # one sync a block, the user side's then the item side's
    syncs = named(spans, "als.sync")
    per_sweep = [sum(inside(s, w) for s in syncs) for w in sweeps]
    blocks = [m._user_plan.n_blocks, m._item_plan.n_blocks]
    assert blocks[0] > 1 and per_sweep == blocks * 3
    assert len(syncs) == sum(per_sweep)


def test_cer_fallback_span_counts_the_direct_solves(inter):
    """le = -1e5 makes le·I + lv·F·Fᵀ negative definite: the first E-solve's
    factor fails and every E-solve is a direct solve."""
    m = _cer(inter, d=120, le=-1e5)
    # le < 0 makes the loss negative, and with it the relative change the
    # convergence test reads: a tol of -inf runs all three iterations
    with pytest.warns(RuntimeWarning, match="no Cholesky factor"):
        _, spans = traced(lambda: m.train(max_iter=3, tol=-np.inf,
                                          verbose=False))
    direct = named(spans, "cer.esolve_direct")
    assert len(direct) == 3 and each_inside(spans, "cer.esolve_direct",
                                            "cer.esolve")
    assert len(named(spans, "cer.factor")) == 1
    assert each_inside(spans, "cer.factor", "cer.gram")
    assert named(spans, "cer.cg_step") == []


def test_cer_train_bitwise_equal_with_spans_on(inter):
    plain = _cer(inter, d=120)
    spanned = _cer(inter, d=120)
    plain.train(max_iter=2, tol=0.0, verbose=False)
    with recording():
        traced(lambda: spanned.train(max_iter=2, tol=0.0, verbose=False))
    for name in ("fue", "fie", "E"):
        assert np.array_equal(getattr(plain, name), getattr(spanned, name))
