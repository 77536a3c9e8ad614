"""Recommender base class: training data and the embedding interchange
(counterpart of ``topk_rec_tpu/models/base.py``).

A model trains on one explicit device; its tables and optimizer state are
buffers of an ``nn.Module`` that it holds (``BPRTables`` for BPR). The model
itself is not a module: its ``train`` is the JAX API's training loop, which
must not shadow ``nn.Module.train``. The exported host arrays keep the
reference's names: ``fue`` -> ``final-U.dat``, ``fie`` -> ``final-V.dat``,
``fib`` -> ``final-B.dat``, written and read with the shared ``write_dat``
/ ``read_dat``, so the JAX package and the reference read what this package
writes. ``checkpoint.npz`` beside them holds the model's own state (for BPR
the RMSProp accumulators) under the JAX package's keys.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Dict, Optional

import numpy as np

from topk_rec_tpu.data.dataset import Interactions
from topk_rec_tpu.data.io import read_dat, write_dat
from topk_rec_tpu.utils import tprint

from ..device import resolve_device


class Recommender(ABC):
    """Base of the port's models: data loading, ``.dat`` / ``checkpoint.npz``
    export and import, and host scoring."""

    def __init__(self, k: int, device="cuda"):
        self.k = k
        self.device = resolve_device(device)
        self.inter: Optional[Interactions] = None
        self.uids: Optional[Dict[str, int]] = None
        self.iids: Optional[Dict[str, int]] = None
        self.n_users = 0
        self.n_items = 0
        self.fue: Optional[np.ndarray] = None
        self.fie: Optional[np.ndarray] = None
        self.fib: Optional[np.ndarray] = None

    # ---- data loading ----

    def load_training_data(self, uid_file: str, iid_file: str,
                           tr_file: str) -> None:
        """Read a fold in the reference's formats (base.py:51-58)."""
        tprint(f"Load training data from {tr_file}")
        inter, uids, iids = Interactions.from_files(uid_file, iid_file,
                                                    tr_file)
        self.set_interactions(inter, uids, iids)
        tprint("Loading finished!")

    def set_interactions(self, inter: Interactions,
                         uids: Optional[Dict[str, int]] = None,
                         iids: Optional[Dict[str, int]] = None) -> None:
        self.inter = inter
        self.n_users = inter.n_users
        self.n_items = inter.n_items
        self.uids = uids
        self.iids = iids
        self._on_data_loaded()

    def _on_data_loaded(self) -> None:
        """Hook for subclasses to build their device layouts."""

    @abstractmethod
    def train(self, *args, **kwargs) -> None: ...

    # ---- interchange (.dat text contract) ----

    def export_embeddings(self, model_path: str) -> None:
        """Write final-U/V/B.dat for the tables that exist, then the
        model's ``checkpoint.npz`` (base.py:97-115)."""
        if not os.path.exists(model_path):
            tprint(f"{model_path} does not exist, create it instead")
            os.makedirs(model_path, exist_ok=True)
        if not os.path.isdir(model_path):
            tprint(f"{model_path} is not a folder")
            return
        for name, mat in (("U", self.fue), ("V", self.fie), ("B", self.fib)):
            if mat is not None:
                write_dat(os.path.join(model_path, f"final-{name}.dat"), mat)
        self.export_model(model_path)

    def import_embeddings(self, model_path: str) -> None:
        """Warm start from exported text tables (base.py:117-128)."""
        p = os.path.join(model_path, "final-U.dat")
        if os.path.exists(p):
            self.fue = read_dat(p, self.uids)
        p = os.path.join(model_path, "final-V.dat")
        if os.path.exists(p):
            self.fie = read_dat(p, self.iids)
        p = os.path.join(model_path, "final-B.dat")
        if os.path.exists(p):
            self.fib = read_dat(p, self.iids)
        self.import_model(model_path)

    # ---- native checkpoint (model-specific state) ----

    def export_model(self, model_path: str) -> None:
        state = self._native_state()
        if state:
            np.savez(os.path.join(model_path, "checkpoint.npz"), **state)

    def import_model(self, model_path: str) -> None:
        p = os.path.join(model_path, "checkpoint.npz")
        if os.path.exists(p):
            with np.load(p) as data:
                self._load_native_state(dict(data))

    def _native_state(self) -> Dict[str, np.ndarray]:
        return {}

    def _load_native_state(self, state: Dict[str, np.ndarray]) -> None:
        pass

    # ---- scoring ----

    def scores(self, cand_item_ids: np.ndarray) -> np.ndarray:
        """U · V_candᵀ (+ bias) over a candidate subset, on the host."""
        if self.fue is None or self.fie is None:
            raise ValueError("the model has no exported tables yet")
        s = self.fue @ self.fie[cand_item_ids].T
        if self.fib is not None:
            s = s + self.fib.reshape(-1)[cand_item_ids][None, :]
        return s
