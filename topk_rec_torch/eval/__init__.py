"""On-device evaluation (counterpart of ``topk_rec_tpu/eval``).

Submodules are imported explicitly (``topk_rec_torch.eval.device``,
``topk_rec_torch.eval.protocol``); this ``__init__`` imports nothing, so
loading the protocol types never loads the evaluator.
"""
