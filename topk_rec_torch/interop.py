"""JAX-package parameters <-> the port's tensors.

The JAX package exports a trained model as host NumPy arrays: ``fue``,
``fie`` and ``fib`` of a ``Recommender`` (``topk_rec_tpu/models/base.py:
31-47``), which are also what ``read_dat`` gives for ``final-U/V/B.dat``.
:func:`from_jax_params` moves them onto a torch device as the inputs of
``TopKServer`` (and of the evaluator, which takes the same three tables).
:func:`bpr_from_jax` and :func:`bpr_to_jax` carry a BPR's whole training
state (tables and RMSProp accumulators) between the two packages.
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


def bpr_from_jax(model, params, ms) -> None:
    """Load a JAX BPR's state into the port's ``BPR`` ``model``.

    ``params`` and ``ms`` are the JAX model's ``_params`` and ``_ms``
    dictionaries ({"ue", "ie", "ib"}), as numpy arrays. ``model`` must have
    its training data set; its tables are replaced and its exported host
    tables follow.
    """
    from .models.bpr import BPRTables

    def host(tree, name):
        return torch.from_numpy(np.asarray(tree[name], np.float32))

    model.tables = BPRTables(host(params, "ue"), host(params, "ie"),
                             host(params, "ib")).to(model.device)
    model.tables.load(ms=ms)
    model._sync_host()


def bpr_to_jax(model):
    """``(params, ms)`` of the port's ``BPR`` as the JAX BPR's ``_params``
    and ``_ms`` dictionaries of numpy arrays (convert them with
    ``jnp.asarray`` on the JAX side)."""
    def host(tree):
        return {n: t.detach().cpu().numpy().copy() for n, t in tree.items()}

    return host(model.tables.params()), host(model.tables.ms())
