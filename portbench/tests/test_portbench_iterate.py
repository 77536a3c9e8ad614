"""The ``iterate`` kind on the CPU at a small size: the driver's restart
gives equal calls and a sound run is correct, every planted fault and the
control are not, the manifest finds the kind and its metrics, the metrics
read synthetic traces, CER's operation counts, and the two copies of the
plain CER agree."""

import importlib.util
import math
import os
import time

import numpy as np
import pytest
import torch

from conftest import ROOT, SMALL

from portbench import faults_iterate
from portbench.harness import checks_iterate, manifest, opcount_cer
from portbench.harness.drivers import iterate
from portbench.harness.launch_trace import LaunchTrace, extent_s, launched_s
from portbench.reference.als import PlainCER
from portbench.reference.precision import bf16

CELL = "cer-ml10m.iterate"
SEED = 2**31 + 77
NEW = ["als_sweep_ms_per_iter", "als_syncs_per_iter", "cer_esolve_ms_per_iter",
       "cer_cg_steps_per_iter", "cer_esolve_direct_per_call",
       "cer_prologue_ms_per_call", "esolve_roofline_pct.iterate",
       "device_busy_pct.iterate", "mfu_pct.iterate"]


def small_iterate():
    """(config, traffic) of the cell at a size the CPU runs in seconds: d
    above n_items, so the E-solve takes the Woodbury-CG route, and four
    iterations a call."""
    inp = manifest.cell_inputs(manifest.load(), CELL)
    return (dict(inp["config"], **SMALL, d=1000),
            dict(inp["traffic"], max_iter=4))


def run(fault=None, seconds=0.3, trace=False):
    cfg, traffic = small_iterate()
    args = (cfg, traffic, SEED, seconds, trace, torch.device("cpu"),
            time.perf_counter())
    if fault is None:
        return iterate.run(*args)
    with faults_iterate.faults()[fault]():
        return iterate.run(*args)


def test_restart_gives_equal_calls():
    cfg, traffic = small_iterate()
    fold, feat, model, obs, init, first = iterate.setup(
        cfg, traffic, SEED, torch.device("cpu"))
    assert len(first.losses) == traffic["max_iter"]
    assert first.steps and all(s > 0 for s in first.steps)
    assert first.fallbacks == 0
    iterate.run_call(model, obs, init, traffic)
    for name, t in (("fue", first.U), ("fie", first.V), ("E", first.E)):
        assert np.array_equal(getattr(model, name), t), name
    # the initial tables are left as they were
    assert not np.array_equal(init.V, first.V)
    again = iterate.initial_tables(model)
    assert np.array_equal(again.E, init.E)


def test_sound_run_is_correct():
    out = run(trace=True)
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted > 0 and out.failed == 0
    assert out.metrics["train_samples_per_s"] > 0
    assert {c.name for c in out.checks} == {
        "loss_gap", "u_gap", "v_gap", "e_gap", "esolve_fallbacks"}
    # the spans of the program, read from the profiled call
    r = {n: manifest.reader(n)(out.trace) for n in NEW}
    assert r["als_syncs_per_iter"] == 2.0  # one block a side at this size
    assert r["cer_cg_steps_per_iter"] == out.trace.counts["cg_steps"] / 4
    assert r["cer_esolve_direct_per_call"] == 0.0
    assert r["als_sweep_ms_per_iter"] > 0 and r["cer_esolve_ms_per_iter"] > 0
    assert r["cer_prologue_ms_per_call"] > 0
    # no device records on the CPU
    assert r["esolve_roofline_pct.iterate"] is None
    assert r["device_busy_pct.iterate"] is None


@pytest.mark.parametrize("fault", sorted(faults_iterate.faults()))
def test_fault_is_not_correct(fault):
    out = run(fault)
    assert not out.correct, [(c.name, c.value, c.limit) for c in out.checks]


def test_control_is_not_correct():
    cfg, traffic = small_iterate()
    fold, feat, _, _, init, _ = iterate.setup(cfg, traffic, SEED,
                                              torch.device("cpu"))
    args = (cfg, fold, torch.from_numpy(feat), init, traffic["max_iter"],
            "cpu")
    ref = checks_iterate.reference(*args)
    c = checks_iterate.reference(*args, state_rounding=bf16)
    ctrl = checks_iterate.Call(c[0], *(t.float().numpy() for t in c[1:]),
                               [], 0)
    found = checks_iterate.iterate(cfg, ctrl, ref)
    assert not all(ch.ok for ch in found)


def test_manifest_finds_the_kind_and_its_metrics():
    man = manifest.load()
    inp = manifest.cell_inputs(man, CELL)
    assert inp["traffic"]["kind"] == "iterate"
    assert manifest.driver("iterate").run is iterate.run
    assert [m["name"] for m in manifest.end_to_end(man, CELL)] == [
        "train_samples_per_s", "setup_s"]
    assert [m["name"] for m in manifest.per_layer(man, CELL)] == NEW
    cfg = inp["config"]
    assert set(cfg["limits"]["iterate"]) == {
        "loss_gap", "u_gap", "v_gap", "e_gap", "esolve_fallbacks"}
    assert cfg["reduced"] == [] and cfg["d"] > cfg["n_items"]
    # the serve cell at 8,192 users reports the serve cell's metrics
    assert [m["name"] for m in manifest.per_layer(
        man, "bpr-ml10m.serve-b8192")] == [
        m["name"] for m in manifest.per_layer(man, "bpr-ml10m.serve-b256")]


def host(*events):
    return [("tkr." + n, s, e - s) for n, s, e in events]


def iterate_trace():
    """One call: the upload [0, 1], an iteration [1, 9] with two sweeps
    (three syncs), an E-solve [5, 8] whose first part builds the Gram
    [5, 5.1] and then runs two CG steps, the loss read, and the write-back
    [9, 10]. Device records: the Gram launched at 5.05, running [5.2, 6];
    a step's product launched at 6.2, running [6.3, 6.8]; the last product
    launched at 7.9, running [8.0, 8.5], after the span's end."""
    dev = [("gemm_gram", 5.2, 0.8), ("gemm_step", 6.3, 0.5),
           ("gemm_ftx", 8.0, 0.5), ("sweep", 2.0, 1.0)]
    launched = [5.05, 6.2, 7.9, 1.9]
    return LaunchTrace(
        "iterate", 10.0, dev,
        host(("cer.features", 0, 1), ("cer.iter", 1, 9),
             ("als.half_sweep", 1, 3), ("als.sync", 1.5, 1.6),
             ("als.sync", 2.5, 2.6), ("als.half_sweep", 3, 5),
             ("als.sync", 4.5, 4.6), ("cer.esolve", 5, 8),
             ("cer.gram", 5, 5.1), ("cer.cg_step", 6, 7),
             ("cer.cg_step", 7, 7.9), ("cer.loss", 8.6, 8.7),
             ("cer.writeback", 9, 10)),
        counts={"calls": 1, "iterations": 1, "cg_steps": 2,
                "direct_solves": 0, "esolve_bound_s": 0.65},
        window={"samples_per_s": 1.0, "s_per_call": 20.0,
                "flops_per_s": 6.7e12},
        launched=launched)


def test_extents_and_launches():
    t = iterate_trace()
    assert extent_s(t, "cer.gram") == pytest.approx(1.0)      # 5 to 6
    assert extent_s(t, "cer.esolve") == pytest.approx(3.5)    # 5 to 8.5
    assert extent_s(t, "cer.features") == pytest.approx(1.0)  # no records
    assert launched_s(t, "cer.esolve") == pytest.approx(1.8)
    assert launched_s(t, "cer.esolve", but="cer.gram") == pytest.approx(1.0)


def test_readers_on_a_synthetic_trace():
    t = iterate_trace()
    r = {n: manifest.reader(n)(t) for n in NEW}
    assert r["als_sweep_ms_per_iter"] == pytest.approx(4e3)
    assert r["als_syncs_per_iter"] == 3.0
    assert r["cer_esolve_ms_per_iter"] == pytest.approx(2.5e3)
    assert r["cer_cg_steps_per_iter"] == 2.0
    assert r["cer_esolve_direct_per_call"] == 0.0
    assert r["cer_prologue_ms_per_call"] == pytest.approx(3e3)
    assert r["esolve_roofline_pct.iterate"] == pytest.approx(65.0)
    assert r["device_busy_pct.iterate"] == pytest.approx(100 * 2.8 / 20)
    assert r["mfu_pct.iterate"] == pytest.approx(10.0)


def test_nothing_read_without_spans_or_launches():
    """A program without CER's spans, or a trace without launches, reads
    as no spans: each span metric returns None; the device metrics still
    read; a trace of another kind reads nothing."""
    t = iterate_trace()
    bare = LaunchTrace("iterate", 10.0, t.device,
                       [("aten::mm", 5.0, 0.1)], counts=t.counts,
                       window=t.window,
                       launched=[math.nan] * len(t.device))
    for name in NEW[:7]:
        assert manifest.reader(name)(bare) is None, name
    assert manifest.reader("device_busy_pct.iterate")(bare) > 0
    assert manifest.reader("mfu_pct.iterate")(bare) > 0
    other = LaunchTrace("train", 10.0, t.device, t.host, counts=t.counts,
                        window=t.window, launched=t.launched)
    for name in NEW:
        assert manifest.reader(name)(other) is None, name
        assert manifest.reader(name)(None) is None, name


def test_opcount_at_the_cell_size():
    n, d, k = 10380, 20000, 50
    # one CG step's G·P: operations over the fp32 peak, above the bytes
    step = opcount_cer.esolve_bound_s(n, d, k, 1, 0) - \
        opcount_cer.esolve_bound_s(n, d, k, 0, 0)
    assert step == pytest.approx(2 * 2 * n * n * k / 67e12)
    assert 2 * n * n * k / 67e12 > 4 * n * n / 3.35e12
    assert opcount_cer.gram_flops(n, d) == pytest.approx(4.31e12, rel=1e-3)
    assert opcount_cer.product_flops(n, d, k) == pytest.approx(2.076e10,
                                                               rel=1e-3)
    # the half-sweeps' pair sums: 2 x 32.6 GFLOP at 6.4 M pairs
    sums = 2 * 2.0 * 6.4e6 * (k * k + k)
    sweeps = opcount_cer.sweep_flops(int(6.4e6), 69878, n, k)
    assert sums == pytest.approx(6.53e10, rel=1e-3)
    assert sums < sweeps < 1.1 * sums
    per_call = opcount_cer.call_flops(int(6.4e6), 69878, n, d, k,
                                      [54] * 20, [0] * 20)
    want = (opcount_cer.gram_flops(n, d) + 21 * 2 * n * d * k
            + 20 * (sweeps + 55 * 2 * n * n * k + 2 * n * d * k))
    assert per_call == pytest.approx(want)
    # a direct fallback costs its LU besides the CG steps before it
    assert opcount_cer.esolve_flops(n, d, k, 60, 1) == pytest.approx(
        61 * 2 * n * n * k + opcount_cer.direct_flops(n, k)
        + 2 * n * d * k)


def test_reference_copies_agree():
    spec = importlib.util.spec_from_file_location(
        "plain_cer_tests", os.path.join(ROOT, "tests", "plain", "cer.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rng = np.random.default_rng(5)
    n_users, n_items, k = 50, 30, 4
    keys = rng.choice(n_users * n_items, 400, replace=False)
    u, i = (torch.as_tensor(keys // n_items), torch.as_tensor(keys % n_items))
    hyper = dict(lu=0.01, lv=10.0, le=1e4, a=1.0, b=0.01)
    for d in (20, 60):
        F = torch.as_tensor(rng.poisson(2.0, (n_items, d)).astype(np.float32))
        U0, V0, E0 = (torch.as_tensor(rng.random(s, dtype=np.float32))
                      for s in ((n_users, k), (n_items, k), (d, k)))
        a = PlainCER(u, i, n_users, n_items, F, hyper, user_block=16).run(
            U0, V0, E0, 3)
        b = mod.PlainCER(u, i, n_users, n_items, F, hyper,
                         user_block=16).run(U0, V0, E0, 3)
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert torch.equal(x, y)
