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
from topk_rec_torch.data import Interactions as PortInteractions
from topk_rec_torch.device import resolve_device
from topk_rec_torch.eval import device as tdev
from topk_rec_torch.experiment import ExperimentSpec, run_experiment
from topk_rec_torch.fusion import ModalityScores
from topk_rec_torch.models import BPR, CER, DPM, VBPR, WMF, MLPEncoder
from topk_rec_torch.ops import topk_floor as tfl
from topk_rec_torch.ops import topk_fused as tf
from topk_rec_torch.ops import topk_hybrid as th
from topk_rec_torch.ops.sampling import TripletSampler
from topk_rec_torch.serving import TopKServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "topk_rec_torch")


def _port(inter):
    """The port's own Interactions over the same arrays as ``inter``."""
    return PortInteractions(inter.n_users, inter.n_items, inter.pos_u,
                            inter.pos_i, inter.seen_u, inter.seen_i)


def _port_modules():
    """Every module of the port, by its dotted name."""
    names = []
    for dirpath, _, files in os.walk(PKG):
        for name in sorted(files):
            if name.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, name), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                names.append(mod[:-len(".__init__")]
                             if mod.endswith(".__init__") else mod)
    return sorted(names)


def test_imports_without_jax():
    """The port imports with jax, the JAX package and scikit-learn blocked
    (the card's machine has no scikit-learn): any import of them raises."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['topk_rec_tpu'] = None\n"
        "sys.modules['sklearn'] = None\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "import topk_rec_torch\n"
        "topk_rec_torch.BPR, topk_rec_torch.TripletSampler\n"
        "topk_rec_torch.VBPR, topk_rec_torch.WMF, topk_rec_torch.CER\n"
        "topk_rec_torch.DPM, topk_rec_torch.MLPEncoder\n"
        "topk_rec_torch.SDAEEncoder, topk_rec_torch.ModalityScores\n"
        "topk_rec_torch.evaluate_fused, topk_rec_torch.run_experiment\n"
        "loaded = [m for m in sys.modules if m.startswith(('jax', "
        "'topk_rec_tpu', 'sklearn')) and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_no_jax_import_lines():
    """No import of jax or of the JAX package in the port or its smoke."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|topk_rec_tpu)\b")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        paths += [os.path.join(dirpath, n) for n in files if n.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as f:
            offenders += [f"{path}:{n}" for n, line in enumerate(f, 1)
                          if pat.match(line)]
    assert not offenders
    assert len(_port_modules()) > 30
    # the kernel and parser sources ship with the package
    for name in ("topk_fused.cu", "topk_count.cu", "topk_floor.cu",
                 "score_tile_sm90.cuh", "io_native.cpp"):
        assert os.path.exists(os.path.join(PKG, "csrc", name))


def test_parallel_exports_the_jax_names():
    """``topk_rec_torch.parallel`` has the five modules of
    ``topk_rec_tpu/parallel`` (imported with jax blocked by
    ``test_imports_without_jax``) and exports every name that package
    exports."""
    import topk_rec_torch.parallel as tpar

    mods = [m for m in _port_modules()
            if m.startswith("topk_rec_torch.parallel.")]
    assert sorted(m.rsplit(".", 1)[1] for m in mods) == [
        "als", "distributed", "lookup", "mesh", "train_step"]
    for name in ("make_mesh", "shard_params", "replicate",
                 "DistributedBPRTrainer", "DistributedVBPRTrainer",
                 "DistributedALS", "initialize", "is_multiprocess", "fetch",
                 "sharded_lookup"):
        assert callable(getattr(tpar, name)), name


def test_one_tile_loop():
    """The kernels share one tile loop: score_tile_sm90.cuh is the only
    header of csrc, and K1, K2 and P1 each include it and run its
    run_tiles."""
    csrc = os.path.join(PKG, "csrc")
    headers = [n for n in os.listdir(csrc) if n.endswith((".cuh", ".h"))]
    assert headers == ["score_tile_sm90.cuh"]
    for name in ("topk_fused.cu", "topk_count.cu", "topk_floor.cu"):
        with open(os.path.join(csrc, name)) as f:
            text = f.read()
        assert re.findall(r'#include "([^"]+)"', text) == headers, name
        assert "run_tiles<" in text, name


def test_lazy_package_attributes():
    assert topk_rec_torch.TopKServer is TopKServer
    assert topk_rec_torch.fused_score_topk is tf.fused_score_topk
    assert topk_rec_torch.exact_topk_hybrid is th.exact_topk_hybrid
    assert topk_rec_torch.topk_floor is tfl.topk_floor
    assert topk_rec_torch.BPR is BPR
    assert topk_rec_torch.VBPR is VBPR
    assert topk_rec_torch.WMF is WMF
    assert topk_rec_torch.CER is CER
    assert topk_rec_torch.DPM is DPM
    assert topk_rec_torch.MLPEncoder is MLPEncoder
    assert topk_rec_torch.ModalityScores is ModalityScores
    assert topk_rec_torch.run_experiment is run_experiment
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
    for make in (lambda: DPM(k=4, d=8), lambda: MLPEncoder(k=4, d=8),
                 lambda: ModalityScores([(np.zeros((2, 3), np.float32),
                                          np.zeros((4, 3), np.float32))])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(SystemExit) as ei:
        torch_cli.main(["fuse", "--strategy", "average", "-d", "x", "-m",
                        "y"])
    assert ei.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err
    spec = ExperimentSpec("x", "y", None, None, {"cf": None}, folds=())
    assert spec.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_experiment(ExperimentSpec(
            str(os.path.join(ROOT, "no_such_dir")), "y", None, None,
            {"cf": None}, folds=(0,)))
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
    model.set_interactions(_port(small_inter))
    model.train(epochs=1, batch_size=32, epoch_sample_limit=64,
                scan_steps=2, verbose=False)
    assert model.sampler.user_rows.device.type == "cpu"
    for t in model.tables.buffers():
        assert t.device.type == "cpu"
    assert np.isfinite(model.fue).all() and model.fue.shape == (120, 4)


def test_cpu_als_and_content_training_stays_on_the_cpu(small_inter):
    """WMF, CER, VBPR and DPM on the CPU keep their tables (and DPM its
    encoder) there and hand back host arrays."""
    feat = np.random.default_rng(1).normal(
        size=(small_inter.n_items, 12)).astype(np.float32)
    for model in (WMF(k=4, block_size=64, device="cpu"),
                  CER(k=4, d=12, block_size=64, device="cpu"),
                  VBPR(k=4, d=12, lr=0.05, device="cpu")):
        model.set_interactions(_port(small_inter))
        if model.d:
            model.set_features(feat)
        if isinstance(model, VBPR):
            model.train(epochs=1, batch_size=32, epoch_sample_limit=64,
                        scan_steps=2, verbose=False)
        else:
            model.train(max_iter=2, verbose=False)
        for t in model.tables.buffers():
            assert t.device.type == "cpu"
        assert type(model.fie) is np.ndarray and np.isfinite(model.fie).all()
    dpm = DPM(k=4, d=12, block_size=64, device="cpu")
    dpm.set_interactions(_port(small_inter))
    dpm.set_features(feat)
    dpm.train(MLPEncoder(k=4, d=12, hidden_layers=(8,), device="cpu"),
              max_iter=2, verbose=False)
    for t in [*dpm.tables.buffers(), *dpm.encoder.parameters(),
              *dpm.encoder.buffers()]:
        assert t.device.type == "cpu"
    assert type(dpm.fie) is np.ndarray and np.isfinite(dpm.fie).all()
