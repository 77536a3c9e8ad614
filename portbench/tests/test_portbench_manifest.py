"""BENCHMARK.json against the rules a manifest keeps, and the loader finding a
configuration, a traffic mix, a metric and a cell added as files only."""

import json
import os
import re
import shutil

from conftest import ROOT

from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_rules():
    man = manifest.load()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["portbench"]
    assert 1 <= man["run_seconds"] <= 51
    metrics = man["end_to_end"] + man["per_layer"]
    names = [x["name"] for x in man["configs"] + man["workloads"] + metrics]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for cfg in man["configs"]:
        assert cfg["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(ROOT, cfg["file"]))
        assert any(w["config"] == cfg["name"] for w in man["workloads"])
    for w in man["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        inp = manifest.cell_inputs(man, w["name"])
        assert inp["traffic"]["kind"] in ("train", "serve", "evaluate")
        reported = {m["name"] for m in manifest.end_to_end(man, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        layer = manifest.per_layer(man, w["name"])
        assert layer and all(m["moves"] in reported for m in layer)
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert callable(manifest.reader(m["name"]))
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    assert len(json.dumps(man)) < 64 * 1024


def test_added_files_are_found(tmp_path):
    """A configuration, a traffic mix, a per-layer metric and a cell are
    added as new files and entries; no file of the harness changes."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = manifest.load(str(tmp_path))
    cfg = json.load(open(tmp_path / "portbench/configs/bpr-ml10m.json"))
    cfg["k"] = 64
    (tmp_path / "portbench/configs/bpr-k64.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/traffic/serve-b8192.json").write_text(json.dumps(
        {"kind": "serve", "batch_users": 8192, "k": 30, "method": "kernel",
         "request_pool": 64, "check_every": 8, "warmup_batches": 4,
         "profile_batches": 8}))
    (tmp_path / "portbench/metrics/k1_share_pct.serve.py").write_text(
        "def read(trace):\n    return None if trace is None else 42.0\n")
    man["configs"].append({"name": "bpr-k64", "source": "test",
                           "file": "portbench/configs/bpr-k64.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "bpr-k64.serve-b8192",
                             "config": "bpr-k64", "traffic": "serve-b8192",
                             "chips": 1, "why": "test"})
    man["end_to_end"][1]["workloads"].append("bpr-k64.serve-b8192")
    man["per_layer"].append({"name": "k1_share_pct.serve", "unit": "%",
                             "better": "higher", "source": "device_trace",
                             "layer": "kernel K1", "moves": "serve_batch_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    man = manifest.load(str(tmp_path))
    inp = manifest.cell_inputs(man, "bpr-k64.serve-b8192", str(tmp_path))
    assert inp["config"]["k"] == 64
    assert inp["traffic"]["batch_users"] == 8192
    assert manifest.driver(inp["traffic"]["kind"]).run
    names = [m["name"] for m in manifest.per_layer(man, "bpr-k64.serve-b8192")]
    assert names == ["k1_share_pct.serve"]
    # the metric without a list of cells is reported wherever its
    # end-to-end metric is, the old serve cell too
    assert "k1_share_pct.serve" in [
        m["name"] for m in manifest.per_layer(man, "bpr-ml10m.serve-b256")]
    assert manifest.reader("k1_share_pct.serve", str(tmp_path))(object()) \
        == 42.0
