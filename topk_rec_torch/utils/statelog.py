"""Solver state logging: ``state.log`` and ``settings.txt`` (counterpart of
``topk_rec_tpu/utils/statelog.py``). The ALS-family models write them when
given a ``log_dir``: one ``iter time likelihood converge`` row per
iteration, and the hyperparameters once."""

from __future__ import annotations

import os
import time
from typing import Mapping, Optional


class StateLog:
    """Append-only iteration log + one-time settings dump."""

    def __init__(self, log_dir: Optional[str], settings: Mapping):
        self.path = None
        if log_dir is None:
            return
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "settings.txt"), "w") as f:
            for key, val in settings.items():
                f.write(f"{key} = {val}\n")
        self.path = os.path.join(log_dir, "state.log")
        self._t0 = time.time()
        with open(self.path, "w") as f:
            f.write("iter time likelihood converge\n")

    def append(self, it: int, likelihood: float, converge: float) -> None:
        if self.path is None:
            return
        with open(self.path, "a") as f:
            f.write(
                "%04d %.2f %.10e %.10e\n"
                % (it, time.time() - self._t0, likelihood, converge)
            )
