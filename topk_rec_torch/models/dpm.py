"""DPM: weighted ALS alternated with a neural content encoder (counterpart
of ``topk_rec_tpu/models/dpm.py``).

Each iteration (reference dpm.py:31-59):

1. the encoder predicts every item's latent vector from its features, Fe,
   and V is replaced by Fe (no warm start of V);
2. the user half-sweep, then the item half-sweep with Fe as the
   lv-weighted prior (the normal equations of CER);
3. the loss fit + 0.5·lu·‖U‖² + 0.5·lv·‖V − Fe‖², plus the summed loss of
   one encoder sweep fitted to the updated V;
4. one ``state.log`` line and the ``save_lag`` dumps.

U, V and Fe stay on the device for the whole loop and the host reads the
loss once per iteration. All ``max_iter`` iterations run (the reference
has no convergence stop). Afterwards the items nobody rated take the final
encoder's prediction (the cold-start write-back, dpm.py:61-64) and the
encoder's device feature cache is released. Defaults mirror reference
dpm.py:11: lu = 0.01, lv = 10, le = 1e4, a = 1, b = 0.01.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Type, Union

import numpy as np

from ..utils import tprint
from ..utils.statelog import StateLog
from .encoders import Encoder
from .wmf import WMF


class DPM(WMF):
    def __init__(
        self,
        k: int,
        d: int,
        lu: float = 0.01,
        lv: float = 10.0,
        le: float = 10e3,
        a: float = 1.0,
        b: float = 0.01,
        seed: int = 0,
        block_size: int = 2048,
        device="cuda",
        mesh=None,
    ):
        super().__init__(k, lu, lv, a, b, seed, block_size, device=device,
                         mesh=mesh)
        self.d = d
        self.le = le
        self.encoder: Optional[Encoder] = None

    def train(
        self,
        encoder: Union[Type[Encoder], Encoder],
        max_iter: int = 200,
        model_path: Optional[str] = None,
        verbose: bool = True,
        log_dir: Optional[str] = None,
        pretrain: bool = True,
        save_lag: Optional[int] = None,
        save_dir: Optional[str] = None,
        fit_batch: Optional[int] = None,
    ) -> None:
        """Alternating ALS / encoder-SGD training (dpm.py:51-174).

        ``encoder`` is an encoder class, built as ``(k, d,
        device=self.device)`` (and ``mesh=self.mesh`` with a mesh), or an
        instance. ``fit_batch`` overrides the
        encoder's minibatch for the fit sweeps (the reference's 64 makes
        ~162 sequential steps per sweep on the MovieLens catalog). A warm
        start from ``model_path`` loads the tables and, through
        ``checkpoint.npz``, the encoder. ``pretrain`` calls the encoder's
        ``pretrain`` once before the loop (a no-op for the MLP).
        """
        if self.inter is None or self.feat is None:
            raise ValueError("DPM needs training data and features")
        if isinstance(encoder, type):
            # a mesh model fits its encoder data-parallel (dpm.py:84-88)
            extra = {} if self.mesh is None else {"mesh": self.mesh}
            self.encoder = encoder(self.k, self.d, device=self.device,
                                   **extra)
        else:
            self.encoder = encoder
        if fit_batch is not None:
            self.encoder.batch_size = int(fit_batch)
        if model_path is not None and os.path.isdir(model_path):
            self.import_embeddings(model_path)
        slog = StateLog(log_dir, {
            "model": "dpm", "k": self.k, "d": self.d, "lu": self.lu,
            "lv": self.lv, "le": self.le, "a": self.a, "b": self.b,
            "max_iter": max_iter,
        })
        if pretrain:
            self.encoder.pretrain(self.feat, None)
        t = self._device_tables()
        prev_loss = None
        for it in range(max_iter):
            t1 = time.time()
            Fe = self.encoder._predict_dev(self.feat)
            t.V = Fe
            fit = self._sweeps(prior=Fe)
            loss = float(fit + self._loss_reg(Fe)
                         + self.encoder._fit_sweep(self.feat, t.V))
            cond = (abs(prev_loss - loss) / abs(prev_loss)
                    if prev_loss is not None else float("inf"))
            prev_loss = loss
            slog.append(it, loss, cond)
            if save_lag and save_dir and it % save_lag == 0:
                self._save_lag_dump(save_dir, it)
            if verbose:
                tprint("Iter %3d, loss %.6f, time %.2fs"
                       % (it, loss, time.time() - t1))
        self._sync_host()
        # cold-start write-back from the final encoder (ref dpm.py:61-64)
        Fe = self.encoder.predict(self.feat)
        unrated = np.setdiff1d(np.arange(self.n_items),
                               self.inter.rated_items)
        self.fie[unrated] = Fe[unrated]
        if hasattr(self.encoder, "drop_feature_cache"):
            self.encoder.drop_feature_cache()

    # ---- the encoder's checkpoint (ref dpm.py:66-76) ----

    def _native_state(self) -> Dict[str, np.ndarray]:
        return self.encoder.state_dict() if self.encoder is not None else {}

    def _load_native_state(self, state: Dict[str, np.ndarray]) -> None:
        if self.encoder is not None:
            self.encoder.load_state_dict(state)
