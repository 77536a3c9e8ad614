"""The control, the plain reference put in the program's place in the
float type just below the configuration's, comes out not correct: it fails
at least one of its cell's limits (here at a size the CPU holds; on the
card at the cell's size with ``portbench/calibrate.py``)."""

import pytest
import torch

from conftest import cells, small_cell

from portbench import calibrate
from portbench.harness.result import Check

CPU = torch.device("cpu")


def over_limit(cfg, kind, nums):
    lim = cfg["limits"][kind]
    return [n for n, v in nums.items() if not Check(n, v, lim[n]).ok]


@pytest.mark.parametrize("cell", ["bpr-ml10m.train-b256",
                                  "vbpr-ml10m.train-b256",
                                  "bpr-ml10m.serve-b256",
                                  "bpr-ml10m.evaluate"])
def test_control_is_not_correct(cell, monkeypatch):
    assert cell in cells()
    cfg, traffic = small_cell(cell)
    kind = traffic["kind"]
    if kind == "train":
        prog, _, state = calibrate.train_case(cfg, traffic, 2**32 + 3, CPU)
        ctrl = calibrate.train_control(cfg, state, CPU)
    else:
        monkeypatch.setattr(calibrate, "SERVE_BATCHES", 8)
        case = (calibrate.serve_cases if kind == "serve"
                else calibrate.evaluate_cases)
        got = case(cfg, traffic, 2**32 + 3, CPU, True, [])
        prog, ctrl = got["program"], got["control"]
    assert over_limit(cfg, kind, prog) == []
    assert over_limit(cfg, kind, ctrl)
