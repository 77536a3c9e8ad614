"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have (``portbench/faults.py``), planted in the
program, through the rest of a run at a size the CPU holds. The harness's
look for a card is skipped by handing the driver the CPU."""

import time

import pytest
import torch

from conftest import small_cell

from portbench import faults
from portbench.harness import manifest

CELLS = {"bpr-ml10m.train-b256": ("state_unchanged", "half_batch",
                                  "altered_answer"),
         "vbpr-ml10m.train-b256": ("state_unchanged", "half_batch",
                                   "altered_answer"),
         "bpr-ml10m.serve-b256": ("half_batch", "altered_answer"),
         "bpr-ml10m.evaluate": ("half_batch", "altered_answer")}


def run(cell, fault=None, seed=2**31 + 99):
    cfg, traffic = small_cell(cell)
    drv = manifest.driver(traffic["kind"])
    if fault is None:
        return drv.run(cfg, traffic, seed, 0.3, False, torch.device("cpu"),
                       time.perf_counter())
    with faults.faults(traffic["kind"], cfg["model"])[fault]():
        return drv.run(cfg, traffic, seed, 0.3, False, torch.device("cpu"),
                       time.perf_counter())


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in CELLS.items()
                                        for f in fs])
def test_fault_is_not_correct(cell, fault):
    out = run(cell, fault)
    assert not out.correct, [(c.name, c.value, c.limit) for c in out.checks]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    out = run(cell)
    assert out.correct, [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted > 0 and out.failed == 0
    assert set(out.metrics) >= {"setup_s"}
