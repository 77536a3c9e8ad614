"""JAX-package parameters <-> the port's tensors.

The JAX package exports a trained model as host NumPy arrays: ``fue``,
``fie`` and ``fib`` of a ``Recommender`` (``topk_rec_tpu/models/base.py:
31-47``), which are also what ``read_dat`` gives for ``final-U/V/B.dat``.
:func:`from_jax_params` moves them onto a torch device as the inputs of
``TopKServer`` (and of the evaluator, which takes the same three tables).
:func:`bpr_from_jax` and :func:`bpr_to_jax` carry a BPR's whole training
state (tables and RMSProp accumulators) between the two packages, and
:func:`vbpr_from_jax` / :func:`vbpr_to_jax` a VBPR's. WMF and CER need no
converter: their state is the host arrays ``fue``, ``fie`` and ``E`` in
both packages. DPM's is those arrays and its encoder's weights:
:func:`encoder_from_jax` / :func:`encoder_to_jax` carry an encoder's state
under the JAX package's keys (``W{i}``, ``b{i}``, ``mW{i}``, ``mb{i}``), and
:func:`dpm_from_jax` a whole DPM's. :func:`distributed_from_jax` and
:func:`distributed_to_jax` carry the state of a distributed BPR or VBPR
trainer: full host arrays on the JAX side, each rank's row shards on the
port's mesh.
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
    """``(params, ms)`` of the port's ``BPR`` (or ``VBPR``) as the JAX
    model's ``_params`` and ``_ms`` dictionaries of numpy arrays (convert
    them with ``jnp.asarray`` on the JAX side)."""
    def host(tree):
        return {n: t.detach().cpu().numpy().copy() for n, t in tree.items()}

    return host(model.tables.params()), host(model.tables.ms())


def vbpr_from_jax(model, params, ms) -> None:
    """Load a JAX VBPR's state into the port's ``VBPR`` ``model``.

    ``params`` and ``ms`` are the JAX model's ``_params`` and ``_ms``
    dictionaries ({"ure", "uce", "ire", "irb", "cem", "icb"}), as numpy
    arrays. ``model`` must have its training data and features set; its
    tables are replaced and its exported host tables follow.
    """
    from .models.vbpr import NAMES, VBPRTables

    model.tables = VBPRTables(
        {n: torch.from_numpy(np.asarray(params[n], np.float32))
         for n in NAMES}).to(model.device)
    model.tables.load(ms=ms)
    model._sync_host()


vbpr_to_jax = bpr_to_jax  # VBPRTables has BPRTables' params()/ms()


def encoder_from_jax(encoder, jax_encoder_state) -> None:
    """Load a JAX encoder's weights and RMSProp accumulators into the port's
    ``MLPEncoder`` or ``SDAEEncoder`` ``encoder``. ``jax_encoder_state`` is
    the JAX encoder itself or its ``state_dict()`` (numpy arrays)."""
    state = (jax_encoder_state.state_dict()
             if hasattr(jax_encoder_state, "state_dict")
             else jax_encoder_state)
    encoder.load_state_dict({n: np.asarray(a) for n, a in state.items()})


def encoder_to_jax(encoder):
    """The port's encoder state as the JAX encoder's ``state_dict()``:
    numpy arrays under ``W{i}``, ``b{i}``, ``mW{i}``, ``mb{i}`` (load them
    with the JAX encoder's ``load_state_dict``)."""
    return encoder.state_dict()


def dpm_from_jax(model, jax_model) -> None:
    """Copy a JAX DPM's tables (``fue``, ``fie``) and encoder state into the
    port's ``DPM`` ``model``. When ``model`` has no encoder yet, an
    ``MLPEncoder`` with the layer widths of the JAX encoder's weights is
    made on the model's device (SDAE and MLP share the network)."""
    from .models.encoders import MLPEncoder

    state = jax_model.encoder.state_dict()
    if model.encoder is None:
        n = sum(1 for name in state if name.startswith("W"))
        hidden = tuple(int(state[f"W{i}"].shape[1]) for i in range(n - 1))
        model.encoder = MLPEncoder(model.k, model.d, hidden_layers=hidden,
                                   device=model.device)
    encoder_from_jax(model.encoder, state)
    model.fue = np.array(jax_model.fue, dtype=np.float32)
    model.fie = np.array(jax_model.fie, dtype=np.float32)
    model.tables = None


def distributed_from_jax(trainer, params, ms=None) -> None:
    """Load a JAX distributed trainer's state into the port's
    ``DistributedBPRTrainer`` or ``DistributedVBPRTrainer`` ``trainer``.

    ``params`` and ``ms`` are the JAX trainer's ``params`` and ``ms`` read
    back whole (``topk_rec_tpu.parallel.fetch`` of each array), as numpy
    arrays under JAX's keys. Every rank passes the same arrays and keeps
    its own shards, as ``trainer.PARAM_SPECS`` places them."""
    def host(tree):
        return {n: np.asarray(a, np.float32) for n, a in tree.items()}

    trainer.load(host(params), None if ms is None else host(ms))


def distributed_to_jax(trainer):
    """``(params, ms)`` of the port's distributed trainer, gathered onto
    every rank, as the full numpy arrays under JAX's keys that the JAX
    trainer's ``params`` and ``ms`` hold (place them with
    ``topk_rec_tpu.parallel.shard_params``)."""
    def host(tree):
        return {n: t.detach().cpu().numpy().copy() for n, t in tree.items()}

    params, ms = trainer.state()
    return host(params), host(ms)
