"""Settings of the benchmark's own tests (run them with
``python -m pytest portbench/tests``): the ``card`` marker, and each cell
cut to a size the CPU runs in a second."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {"n_users": 1500, "n_items": 600, "n_om_items": 119,
         "n_pairs": 60000, "max_user_pairs": 400}
SMALL_TRAFFIC = {"train": {"chunk_steps": 8, "epoch_samples": 4000},
                 "serve": {"request_pool": 32, "check_every": 4,
                           "profile_batches": 4},
                 "evaluate": {"user_chunk": 512}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


def small_cell(name):
    """(config, traffic) of the cell ``name`` at a size for the CPU."""
    from portbench.harness import manifest

    inp = manifest.cell_inputs(manifest.load(), name)
    cfg = dict(inp["config"], **SMALL)
    if cfg["model"] == "vbpr":
        cfg["d"] = 700
    traffic = dict(inp["traffic"], **SMALL_TRAFFIC[inp["traffic"]["kind"]])
    return cfg, traffic


def cells():
    """Every cell of BENCHMARK.json, read when a test asks, not at import."""
    from portbench.harness import manifest

    return [w["name"] for w in manifest.load()["workloads"]]


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
