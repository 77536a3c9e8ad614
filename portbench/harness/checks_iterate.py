"""The comparisons that decide ``correct`` in a cell of the ``iterate`` kind:
the program's checked call of ``CER.train`` held to the plain float64 CER
of ``portbench/reference/als.py``, run from the same tables.

The numbers, each with its limit under the configuration's
``limits.iterate``:

  ``loss_gap``         the largest relative gap of an iteration's loss, as
                       the program wrote it to ``state.log``;
  ``u_gap``, ``v_gap``, ``e_gap``
                       ‖program - reference‖ / ‖reference‖ of U, V (after
                       the cold-start write-back) and E after the call;
  ``esolve_fallbacks`` E-solves of the call that the program ran as the
                       direct fallback rather than by conjugate gradients
                       (limit 0: at the cell's settings CG converges).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..reference.als import PlainCER
from .checks import reference_device
from .result import Check

REF_BLOCK = 4096  # users whose dense rows the reference forms at once


def hyper(cfg: dict) -> Dict[str, float]:
    return {n: float(cfg[n]) for n in ("lu", "lv", "le", "a", "b")}


@dataclass
class Call:
    """What one call of the program did, copied off the model."""
    losses: List[float]        # each iteration's loss
    U: np.ndarray
    V: np.ndarray
    E: np.ndarray
    steps: List[int]           # CG steps of each E-solve
    fallbacks: int             # E-solves run as the direct fallback


@dataclass
class Initial:
    """The tables every call starts from."""
    U: np.ndarray
    V: np.ndarray
    E: np.ndarray


def reference(cfg: dict, fold, feat: torch.Tensor, init: Initial,
              n_iter: int, device,
              state_rounding: Optional[Callable] = None) -> tuple:
    """(losses, U, V, E) of the plain CER from ``init`` on ``device``."""
    dev = reference_device(device)
    ref = PlainCER(torch.as_tensor(fold.train_u, device=dev),
                   torch.as_tensor(fold.train_i, device=dev),
                   fold.n_users, fold.n_items, feat.to(dev), hyper(cfg),
                   user_block=REF_BLOCK)
    out = ref.run(*(torch.tensor(t, device=dev)
                    for t in (init.U, init.V, init.E)), n_iter,
                  state_rounding=state_rounding)
    del ref
    return out


def _gap(got, want: torch.Tensor) -> float:
    want = want.double()
    got = torch.as_tensor(np.asarray(got), device=want.device).double()
    return float((got - want).norm() / want.norm())


def numbers(call: Call, ref: tuple) -> Dict[str, float]:
    losses, U, V, E = ref
    if len(call.losses) != len(losses):
        loss_gap = float("inf")
    else:
        loss_gap = max(abs(g - r) / abs(r)
                       for g, r in zip(call.losses, losses))
    return {"loss_gap": loss_gap, "u_gap": _gap(call.U, U),
            "v_gap": _gap(call.V, V), "e_gap": _gap(call.E, E),
            "esolve_fallbacks": float(call.fallbacks)}


def iterate(cfg: dict, call: Call, ref: tuple) -> List[Check]:
    lim = cfg["limits"]["iterate"]
    return [Check(n, v, lim[n]) for n, v in numbers(call, ref).items()]
