"""The command's refusals: no result without a card, or without the
program beside the benchmark."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

from portbench.harness import runner


def command(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "bpr-ml10m.serve-b256", "--seed", str(2**31 + 77), "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    r = command(ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "CUDA" in r.stderr


def test_only_the_benchmark_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = command(str(tmp_path))
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "topk_rec_tpu_like", object())
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert runner.forbidden_modules() == ["jaxlib.xla_client"]


def test_metric_values_by_trace(tmp_path):
    from portbench.harness import manifest
    from portbench.harness.result import Outcome
    from portbench.harness.trace import Trace

    man = manifest.load()
    out = Outcome(metrics={"serve_batch_ms": 0.5, "setup_s": 9.0},
                  attempted=3, failed=0, checks=[], memory_peak_bytes=0)
    got = runner.metric_values(man, "bpr-ml10m.serve-b256", out, False,
                               ROOT)
    assert got == {"serve_batch_ms": {"value": 0.5, "unit": "ms"},
                   "setup_s": {"value": 9.0, "unit": "s"}}
    out.trace = Trace("serve", 0.01, [("topk_pass1<x>", 0.0, 1e-4),
                                      ("memcpy", 2e-4, 1e-5)], [],
                      counts={"batches": 2, "k1_bound_s": 1e-6,
                              "flops_per_batch": 1e9},
                      window={"s_per_batch": 5e-4})
    got = runner.metric_values(man, "bpr-ml10m.serve-b256", out, True, ROOT)
    assert got["serve_launches_per_batch"]["value"] == 1.0
    assert abs(got["k1_roofline_pct.serve"]["value"] - 1.0) < 1e-9
    assert abs(got["device_busy_pct.serve"]["value"] - 11.0) < 1e-9
    assert json.dumps(got)
