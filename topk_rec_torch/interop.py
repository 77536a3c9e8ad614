"""JAX-package parameters -> the port's tensors.

The JAX package exports a trained model as host NumPy arrays: ``fue``,
``fie`` and ``fib`` of a ``Recommender`` (``topk_rec_tpu/models/base.py:
31-47``), which are also what ``read_dat`` gives for ``final-U/V/B.dat``.
:func:`from_jax_params` moves them onto a torch device as the inputs of
``TopKServer`` (and of the evaluator, which takes the same three tables).
"""

from __future__ import annotations

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device


def from_jax_params(
    params, device="cuda", table_dtype: Optional[torch.dtype] = None
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(U, V, bias) tensors on ``device`` from a JAX-package model.

    ``params`` is an object with ``fue``/``fie``/``fib`` attributes (a
    trained ``Recommender``) or a mapping with ``"U"``, ``"V"`` and an
    optional ``"B"`` (arrays as ``read_dat`` returns them). U and V are
    stored as ``table_dtype`` (float32 by default); the bias is a flat
    float32 vector, or None when the model has none.
    """
    if isinstance(params, Mapping):
        U, V, B = params["U"], params["V"], params.get("B")
    else:
        U, V, B = params.fue, params.fie, params.fib
    if U is None or V is None:
        raise ValueError("the model has no exported user/item tables")
    dev = resolve_device(device)
    dt = torch.float32 if table_dtype is None else table_dtype

    def to_tensor(a, dtype):
        arr = np.asarray(a, dtype=np.float32)
        # a copy: the port's tensors never alias the model's arrays
        return torch.tensor(arr).to(device=dev, dtype=dtype)

    bias = None if B is None else to_tensor(np.reshape(B, -1), torch.float32)
    return to_tensor(U, dt), to_tensor(V, dt), bias
