"""topk_rec_torch — the PyTorch/CUDA port of ``topk_rec_tpu`` for one NVIDIA H100.

The JAX package ``topk_rec_tpu`` stays the reference; this package is held
against it by the ``tests/test_torch_*.py`` parity tests. Its first slice is
the serving path: ``evaluate`` and ``recommend`` over exported
``final-U/V/B.dat`` tables, with the fused score + seen-mask + top-k kernel
(``ops/topk_fused.py``, CUDA source in ``csrc/topk_fused.cu``) in place of
the Pallas kernel ``topk_rec_tpu/ops/topk_pallas.py:119``. Its second slice
adds the ``approx`` and exact ``hybrid`` serving methods, with the
threshold-count kernel (``ops/topk_hybrid.py``, ``csrc/topk_count.cu``) in
place of ``topk_rec_tpu/ops/topk_hybrid.py:55``. Its third slice adds BPR
training (``train --model bpr``: the device sampler, sparse RMSProp, the
model and npz checkpoints) and P1, the floor of K1 (``ops/topk_floor.py``,
``csrc/topk_floor.cu``), in place of the probe kernel of
``benchmarks/probe_topk_floor.py:44``.

Layout:
  device.py   device resolution and fp32 matmul settings
  ops/        kernels with their plain twins: topk_fused (K1, fused top-k,
              bitmap helpers), topk_hybrid (K2, the threshold-count audit
              of the exact hybrid top-k, and the approx selector),
              topk_floor (P1, K1's floor); and the training ops sampling
              (triplets) and sparse_update (sparse RMSProp)
  models/     Recommender and BPR (counterpart of topk_rec_tpu/models)
  checkpoint.py  npz checkpoints (counterpart of topk_rec_tpu/checkpoint.py)
  eval/       on-device evaluation (counterpart of topk_rec_tpu/eval)
  serving.py  TopKServer (counterpart of topk_rec_tpu/serving.py)
  interop.py  JAX-package parameters and BPR state <-> the port's tensors
  cli.py      ``train`` / ``evaluate`` / ``recommend`` (counterpart of
              topk_rec_tpu/cli.py)

The attribute map below is lazy, as in ``topk_rec_tpu/__init__.py:24-43``:
``import topk_rec_torch`` loads no kernel and no torch module beyond itself.
The port imports only ``topk_rec_tpu.data``, ``.config``, ``.utils`` and
``.native`` from the JAX package, which are jax-free.
"""

__version__ = "0.1.0"

_LAZY = {
    "TopKServer": "topk_rec_torch.serving",
    "DeviceEvaluator": "topk_rec_torch.eval.device",
    "evaluate_scores_device": "topk_rec_torch.eval.device",
    "fused_score_topk": "topk_rec_torch.ops.topk_fused",
    "exact_topk_hybrid": "topk_rec_torch.ops.topk_hybrid",
    "topk_floor": "topk_rec_torch.ops.topk_floor",
    "BPR": "topk_rec_torch.models.bpr",
    "TripletSampler": "topk_rec_torch.ops.sampling",
    "CheckpointManager": "topk_rec_torch.checkpoint",
    "from_jax_params": "topk_rec_torch.interop",
    "resolve_device": "topk_rec_torch.device",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(_LAZY[name])
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
