"""The result's last line and the compared numbers beside their limits."""

import io
import json

from portbench.harness.result import Check, Outcome, line, print_checks


def outcome(checks, failed=0):
    return Outcome(metrics={"setup_s": 1.5}, attempted=10, failed=failed,
                   checks=checks, memory_peak_bytes=123)


def test_line_keys_and_order():
    out = outcome([Check("loss_gap", 1e-8, 1e-5), Check("bad", 0.0, 0)])
    text = line(out, {"setup_s": {"value": 1.5, "unit": "s"}},
                {"platform": "gpu", "kind": "H100", "count": 1,
                 "memory_peak_bytes": 123},
                {"device_ops": [["k", 0.1]], "idle_gaps": []})
    got = json.loads(text)
    assert list(got) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert got["correct"] is True and got["attempted"] == 10
    assert got["checks"]["loss_gap"] == {"value": 1e-8, "limit": 1e-5}
    assert "\n" not in text


def test_correct_needs_every_check_and_no_failure():
    assert not outcome([Check("x", 2.0, 1.0)]).correct
    assert not outcome([Check("x", float("nan"), 1.0)]).correct
    assert not outcome([Check("x", 0.0, 1.0)], failed=1).correct
    assert not outcome([]).correct
    assert outcome([Check("x", 1.0, 1.0)]).correct
    no_breakdown = json.loads(line(outcome([Check("x", 0.0, 0)]), {}, {}))
    assert "breakdown" not in no_breakdown


def test_print_checks():
    buf = io.StringIO()
    print_checks([Check("rank_gap", 0.5, 0.25)], buf)
    assert buf.getvalue() == "check rank_gap 0.5 limit 0.25 FAILED\n"
