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
``benchmarks/probe_topk_floor.py:44``. Its fourth slice adds the content
and ALS trainers (``train --model vbpr|wmf|cer``: the batched weighted-ALS
core, WMF, CER, VBPR, content loading) and ``profile_trace``; they run no
kernel of their own, and their tables are scored through K1. Its fifth
slice makes it stand alone, with its own ``data``, ``config``, ``utils``
and C++ parser, and moves K1 and K2 onto a tile loop for Hopper
(``csrc/score_tile_sm90.cuh``: fp32 on the CUDA cores, bf16 on the tensor
cores). Its sixth moves P1 onto that loop too, so the kernels share one,
and repairs three faults: ``TopKServer``'s kernel copies of U and V now
follow the tables, the checkpoint manager refuses the JAX package's orbax
steps instead of passing over them, and the sampler and ALS entry points
default to the card as every other entry point does. Its seventh completes
the single-device port: DPM with its MLP and SDAE encoders (``train --model
dpm``), late fusion (``fuse``, ``fusion/``), ``topk_unseen_scorer``, the
experiment grid, the text tools and the rest of the data API. They run no
kernel of their own; their tables and fused scores are checked through K1.
Its eighth ports the mesh (``parallel/``): ``TopKServer(mesh=)``, the
distributed BPR and VBPR trainers, the distributed ALS sweep behind
``WMF/CER/DPM(mesh=)``, the data-parallel encoder fit and ``train
--mesh``, on ``torch.distributed`` (NCCL on the card, gloo on the CPU).
With it the port does everything the JAX package does.

Layout:
  config.py   the entry points' dataclass configuration
  data/       fold, id-map, ``.dat`` and feature IO and ``Interactions``
  native/     the C++ fold and ``.dat`` parser, built at first use
  utils/      ``tprint`` and the ALS ``StateLog``
  device.py   device resolution and fp32 matmul settings
  ops/        kernels with their plain twins: topk_fused (K1, fused top-k,
              bitmap helpers), topk_hybrid (K2, the threshold-count audit
              of the exact hybrid top-k, and the approx selector),
              topk_floor (P1, K1's floor); and the training ops sampling
              (triplets), sparse_update (sparse RMSProp) and als (batched
              weighted-ALS half-sweeps)
  models/     Recommender, BPR, VBPR, WMF, CER, DPM and its MLP and SDAE
              encoders (counterpart of topk_rec_tpu/models); BPR (both
              table layouts) and VBPR share pairwise.py's step loop and
              epoch loop and keep their losses, tables and chunk statements
  fusion/     late fusion: ModalityScores, the five weightings,
              evaluate_fused (counterpart of topk_rec_tpu/fusion)
  experiment.py  the fold x modality grid (counterpart of
              topk_rec_tpu/experiment.py)
  tools/      tf-idf features and LDA topics (counterpart of
              topk_rec_tpu/tools)
  checkpoint.py  npz checkpoints (counterpart of topk_rec_tpu/checkpoint.py)
  profiling.py   torch.profiler traces (counterpart of
              topk_rec_tpu/utils/profiling.py)
  eval/       on-device evaluation (counterpart of topk_rec_tpu/eval)
  serving.py  TopKServer (counterpart of topk_rec_tpu/serving.py)
  parallel/   the (dp, mp) rank mesh, the all-to-all lookup and update,
              the distributed trainers and ALS sweep (counterpart of
              topk_rec_tpu/parallel)
  interop.py  JAX-package parameters and BPR/VBPR/DPM state <-> the
              port's tensors
  cli.py      ``train`` / ``evaluate`` / ``fuse`` / ``recommend``
              (counterpart of topk_rec_tpu/cli.py)

The attribute map below is lazy, as in ``topk_rec_tpu/__init__.py:24-43``:
``import topk_rec_torch`` loads no kernel and no torch module beyond itself.
The port imports nothing of the JAX package: ``data``, ``config``, ``utils``
and ``native`` are its own copies of what it needs from there.
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
    "VBPR": "topk_rec_torch.models.vbpr",
    "WMF": "topk_rec_torch.models.wmf",
    "CER": "topk_rec_torch.models.cer",
    "DPM": "topk_rec_torch.models.dpm",
    "MLPEncoder": "topk_rec_torch.models.encoders",
    "SDAEEncoder": "topk_rec_torch.models.encoders",
    "ModalityScores": "topk_rec_torch.fusion.fusion",
    "evaluate_fused": "topk_rec_torch.fusion.fusion",
    "ExperimentSpec": "topk_rec_torch.experiment",
    "run_experiment": "topk_rec_torch.experiment",
    "TripletSampler": "topk_rec_torch.ops.sampling",
    "CheckpointManager": "topk_rec_torch.checkpoint",
    "from_jax_params": "topk_rec_torch.interop",
    "resolve_device": "topk_rec_torch.device",
    "make_mesh": "topk_rec_torch.parallel.mesh",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(_LAZY[name])
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
