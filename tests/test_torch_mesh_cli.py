"""``train --mesh`` of the port's CLI: two processes joined on gloo (the
counterpart of ``tests/test_multiprocess.py``), the JAX CLI's three
``--exchange`` refusals word for word, and ``--mesh auto`` in one process.
"""

import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch.distributed as dist

from test_torch_cli import fold_dir  # noqa: F401  (a fixture)
from topk_rec_tpu import cli as jax_cli
from topk_rec_torch import cli as torch_cli
from topk_rec_torch.config import DataConfig, ModelConfig, TrainConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH = re.compile(r"Epoch +(\d+), loss ([0-9.]+), time [0-9.]+s "
                   r"\(mesh \{'dp': (\d+), 'mp': (\d+)\}\)")
FILES = ["checkpoint.npz", "final-B.dat", "final-U.dat", "final-V.dat"]


def _two_ranks(args, rendezvous, timeout=240):
    """``python -m topk_rec_torch.cli train ARGS`` as processes 0 and 1 of a
    two-process run; returns their standard outputs."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    env.pop("TKR_COORDINATOR", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "topk_rec_torch.cli", "train", *args,
         "--device", "cpu", "--coordinator", f"file://{rendezvous}",
         "--num-processes", "2", "--process-id", str(r)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_process_train_bpr_and_wmf(fold_dir, tmp_path, capsys):
    """BPR on a 1x2 mesh of two processes: both ranks log the same losses,
    the files are written once, and the JAX CLI's ``evaluate`` reads them
    into the port's CSV. WMF on a 2x1 mesh gives the one-process tables."""
    out = tmp_path / "bpr"
    logs = _two_ranks(["--model", "bpr", "-d", str(fold_dir), "-o", str(out),
                       "--k", "8", "--epochs", "2", "--batch-size", "64",
                       "--lr", "0.05", "--mesh", "1x2"], tmp_path / "rdv1")
    epochs = [EPOCH.findall(log) for log in logs]
    assert [e[:1] + e[2:] for e in epochs[0]] == [("1", "1", "2"),
                                                 ("2", "1", "2")]
    assert epochs[0] == epochs[1]
    assert sorted(os.listdir(out)) == FILES
    args = ["evaluate", "-d", str(fold_dir), "-m", str(out), "-sl", "im",
            "om"]
    capsys.readouterr()
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert want.startswith("im,") and "\nom," in want
    assert torch_cli.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want

    wmf = ["--model", "wmf", "-d", str(fold_dir), "--k", "6", "--max-iter",
           "3"]
    _two_ranks(wmf + ["-o", str(tmp_path / "wmf2"), "--mesh", "2x1"],
               tmp_path / "rdv2")
    assert torch_cli.main(["train", *wmf, "-o", str(tmp_path / "wmf1"),
                           "--device", "cpu"]) == 0
    for name in ("final-U.dat", "final-V.dat"):
        got = np.loadtxt(tmp_path / "wmf2" / name)
        want = np.loadtxt(tmp_path / "wmf1" / name)
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max() + 6e-7)


@pytest.mark.parametrize("extra", [
    ["--model", "vbpr", "--exchange", "explicit"],
    ["--model", "bpr", "--exchange", "explicit"],
    ["--model", "bpr", "--exchange", "explicit", "--mesh", "2x4"],
])
def test_exchange_refusals_word_for_word(fold_dir, tmp_path, extra):
    """cli.py:282-300: explicit is for BPR, needs a mesh, and needs a
    pure-mp one. The port refuses with the JAX CLI's own words. A 2x4 mesh
    needs eight processes here, so the port's refusal is asked of
    ``train_from_config`` with a stand-in of that mesh."""
    args = ["train", *extra, "-d", str(fold_dir), "-o",
            str(tmp_path / "out"), "--k", "4"]
    with pytest.raises(SystemExit) as ei:
        jax_cli.main(args)
    want = ei.value.code
    assert isinstance(want, str) and want.startswith("--exchange explicit")
    if "--mesh" in extra:
        cfg = TrainConfig(data=DataConfig(data_dir=str(fold_dir)),
                          model=ModelConfig(model="bpr", k=4),
                          out_dir=str(tmp_path / "out"), exchange="explicit")
        mesh = types.SimpleNamespace(shape={"dp": 2, "mp": 4}, rank=0)
        with pytest.raises(SystemExit) as ei:
            torch_cli.train_from_config(cfg, "cpu", mesh=mesh)
    else:
        with pytest.raises(SystemExit) as ei:
            torch_cli.main(args + ["--device", "cpu"])
    assert ei.value.code == want
    assert not (tmp_path / "out").exists()


@pytest.fixture
def no_process_group():
    """Leaves no process group behind in this pytest process."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_mesh_auto_in_one_process(fold_dir, tmp_path, capsys,
                                  no_process_group):
    """``--mesh auto`` without a launcher makes a one-rank group, trains
    VBPR over a 1x1 mesh, writes the one-process run's files and ends the
    group it made."""
    out = tmp_path / "out"
    assert torch_cli.main([
        "train", "--model", "vbpr", "-d", str(fold_dir), "-o", str(out),
        "--content", "meta.pkl", "--d", "64", "--k", "6", "--epochs", "1",
        "--batch-size", "64", "--lr", "0.05", "--mesh", "auto",
        "--device", "cpu"]) == 0
    assert not dist.is_initialized()
    (epoch,) = EPOCH.findall(capsys.readouterr().out)
    assert epoch[2:] == ("1", "1") and np.isfinite(float(epoch[1]))
    assert sorted(os.listdir(out)) == FILES
    assert np.isfinite(np.loadtxt(out / "final-U.dat")).all()
