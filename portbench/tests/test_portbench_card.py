"""On the card: each cell's command runs briefly, untraced and traced,
and comes out correct with the result's keys. Skips without a card;
run on the card with ``python -m pytest portbench/tests -m card``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, cells


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_every_cell_on_the_card(card, trace):
    for cell in cells():
        r = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload", cell,
             "--seed", str(2**31 + 1234 + trace), "--seconds", "3",
             "--trace", str(trace)],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-3000:]
        res = json.loads(r.stdout.strip().splitlines()[-1])
        assert res["correct"] is True, res["checks"]
        assert res["device"]["platform"] == "gpu"
        assert list(res)[-1] == "checks"
        if trace:
            assert res["device"]["busy_s"] > 0
