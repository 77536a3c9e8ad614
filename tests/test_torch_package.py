"""Package rules of the port: no jax, an explicit device, and CPU tensors
never counted as kernel launches."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import topk_rec_torch
from topk_rec_torch import cli as torch_cli
from topk_rec_torch.device import resolve_device
from topk_rec_torch.eval import device as tdev
from topk_rec_torch.models import BPR
from topk_rec_torch.ops import topk_floor as tfl
from topk_rec_torch.ops import topk_fused as tf
from topk_rec_torch.ops import topk_hybrid as th
from topk_rec_torch.ops.sampling import TripletSampler
from topk_rec_torch.serving import TopKServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "topk_rec_torch")


def test_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any jax import now raises
        "import topk_rec_torch, topk_rec_torch.cli, topk_rec_torch.serving\n"
        "import topk_rec_torch.eval.device, topk_rec_torch.ops.topk_fused\n"
        "import topk_rec_torch.ops.topk_hybrid\n"
        "import topk_rec_torch.interop, topk_rec_torch.eval.protocol\n"
        "import topk_rec_torch.models, topk_rec_torch.models.bpr\n"
        "import topk_rec_torch.ops.sampling\n"
        "import topk_rec_torch.ops.sparse_update\n"
        "import topk_rec_torch.ops.topk_floor, topk_rec_torch.checkpoint\n"
        "topk_rec_torch.BPR, topk_rec_torch.TripletSampler\n"
        "loaded = [m for m in sys.modules if m.startswith('jax')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_jax_import_lines():
    pat = re.compile(r"^\s*(import|from)\s+jax\b")
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                with open(path) as f:
                    offenders += [f"{path}:{n}" for n, line in enumerate(f, 1)
                                  if pat.match(line)]
    assert not offenders
    # the kernel sources ship with the package
    for name in ("topk_fused.cu", "topk_count.cu", "topk_floor.cu",
                 "score_tile.cuh"):
        assert os.path.exists(os.path.join(PKG, "csrc", name))


def test_lazy_package_attributes():
    assert topk_rec_torch.TopKServer is TopKServer
    assert topk_rec_torch.fused_score_topk is tf.fused_score_topk
    assert topk_rec_torch.exact_topk_hybrid is th.exact_topk_hybrid
    assert topk_rec_torch.topk_floor is tfl.topk_floor
    assert topk_rec_torch.BPR is BPR
    assert topk_rec_torch.TripletSampler is TripletSampler
    with pytest.raises(AttributeError):
        topk_rec_torch.no_such_name


def test_cuda_without_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TopKServer(np.zeros((2, 3), np.float32), np.zeros((4, 3), np.float32))
    with pytest.raises(SystemExit) as ei:
        torch_cli.main(["evaluate", "-d", "x", "-m", "y", "--device", "cuda"])
    assert ei.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BPR(k=4)
    with pytest.raises(SystemExit) as ei:
        torch_cli.main(["train", "--model", "bpr", "-d", "x", "-o", "y"])
    assert ei.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_cpu_tensors_never_count_launches():
    rng = np.random.default_rng(0)
    U = rng.normal(size=(30, 5)).astype(np.float32)
    V = rng.normal(size=(40, 5)).astype(np.float32)
    seen = np.zeros((30, 2), np.uint32)
    tf.fused_score_topk.launches = 0
    th.count_vs_threshold.launches = 0
    tfl.topk_floor.launches = 0
    tf.fused_score_topk(torch.from_numpy(U), torch.from_numpy(V), None,
                        torch.zeros(30, 2, dtype=torch.int32), 5)
    tdev.evaluate_scores_device_full(
        U, V, None, seen, np.arange(40), {0: [1]}, use_kernel=True,
        device="cpu",
    )
    srv = TopKServer(U, V, device="cpu")
    for method in ("kernel", "hybrid"):
        srv.recommend(np.arange(4), k=3, method=method)
    for with_index in (False, True):
        tfl.topk_floor(torch.from_numpy(U), torch.from_numpy(V), None,
                       torch.zeros(30, 2, dtype=torch.int32),
                       with_index=with_index)
    assert tf.fused_score_topk.launches == 0
    assert th.count_vs_threshold.launches == 0
    assert tfl.topk_floor.launches == 0


def test_cpu_training_stays_on_the_cpu(small_inter):
    """BPR on the CPU keeps every table, accumulator and draw there."""
    model = BPR(k=4, lr=0.05, device="cpu")
    model.set_interactions(small_inter)
    model.train(epochs=1, batch_size=32, epoch_sample_limit=64,
                scan_steps=2, verbose=False)
    assert model.sampler.user_rows.device.type == "cpu"
    for t in model.tables.buffers():
        assert t.device.type == "cpu"
    assert np.isfinite(model.fue).all() and model.fue.shape == (120, 4)
