"""VBPR: content-aware pairwise ranking (counterpart of
``topk_rec_tpu/models/vbpr.py``).

The latent width splits into rating factors and content factors: a user
has [ure ‖ uce], an item has its rating factors ``ire`` and bias ``irb``
plus the projection of its features F[i]·cem and a content bias F[i]·icb
(reference single/vbpr.py:37-75). ``full_k`` gives both halves the whole
width k, the legacy layout (reference old/methods/vbpr.py:37-43).

The sampler, the step loop and the epoch loop are the pairwise trainers'
(``models/pairwise.py``), as for BPR. VBPR owns its loss
(:func:`_vbpr_loss`), its tables (:class:`VBPRTables`: users [ure ‖ uce]
and items [ire ‖ irb], JAX's row layouts, vbpr.py:147-153), its header
lines, and :func:`run_chunk`: both tables' rows, the content rows F[i],
F[j] (2 × batch × d floats), and ``cem``/``icb`` as dense parameters
under dense RMSProp (vbpr.py:112-114). F stays on the device for the
whole ``train``.

Export composes the whole catalog (vbpr.py:470-477): final-U = [ure ‖ uce],
final-V = [ire ‖ F·cem], final-B = irb + F·icb, so cold-start items are
scored through their features. Random streams are the port's own
(``models/pairwise.py``): not JAX's threefry.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.sparse_update import apply_planned_rmsprop
from ..tracing import span
from ..utils import tprint
from .pairwise import Leaf, PairwiseRecommender, SparseTable, run_planned_steps

NAMES = ("ure", "uce", "ire", "irb", "cem", "icb")  # JAX's _params keys


def _vbpr_loss(put, pit, pjt, cem, icb, ic, jc, hyper, mode, kh,
               dense_reg: bool = True):
    """VBPR batch loss (vbpr.py:74-104) over the fused gathered rows: ``put``
    [B, 2·kh] = [ure ‖ uce], ``pit``/``pjt`` [B, kh + 1] = [ire ‖ irb], and
    the content rows ``ic``/``jc`` [B, d]. ``dense_reg=False`` leaves out
    the regularization of ``cem`` and ``icb``, which a batch split over
    several ranks counts on one of them only."""
    lu, li, lj, lb, le = (hyper[n] for n in ("lu", "li", "lj", "lb", "le"))
    ureb, uceb = put[:, :kh], put[:, kh:]
    ireb, irbb = pit[:, :kh], pit[:, kh]
    jreb, jrbb = pjt[:, :kh], pjt[:, kh]
    iceb = ic @ cem
    jceb = jc @ cem
    x = (irbb - jrbb + (ureb * (ireb - jreb)).sum(1)
         + (uceb * (iceb - jceb)).sum(1) + (ic - jc) @ icb)
    nll = torch.logaddexp(x.new_zeros(()), -x).sum()
    if mode == "l2":
        reg = (0.5 * ((ureb ** 2 + uceb ** 2) * lu + ireb ** 2 * li
                      + jreb ** 2 * lj).sum()
               + 0.5 * (irbb ** 2 + jrbb ** 2).sum() * lb)
        if dense_reg:
            reg = reg + 0.5 * (cem ** 2).sum() * le + 0.5 * (
                icb ** 2).sum() * lb
    else:
        reg = (((ureb.abs() + uceb.abs()) * lu + ireb.abs() * li
                + jreb.abs() * lj).sum()
               + (irbb.abs() + jrbb.abs()).sum() * lb)
        if dense_reg:
            reg = reg + cem.abs().sum() * le + icb.abs().sum() * lb
    return nll + reg


class VBPRTables(nn.Module):
    """The trained state as buffers: the user table ``ut`` [n_users, 2·kh]
    = [ure ‖ uce], the item table ``it`` [n_items, kh + 1] = [ire ‖ irb],
    the content projection ``cem`` [d, kh] and bias ``icb`` [d], and the
    RMSProp accumulator ``ms_<name>`` of each."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.kh = params["ure"].shape[1]
        p = {n: params[n].float() for n in NAMES}
        self.register_buffer("ut", torch.cat([p["ure"], p["uce"]], 1))
        self.register_buffer(
            "it", torch.cat([p["ire"], p["irb"].reshape(-1, 1)], 1))
        self.register_buffer("cem", p["cem"].contiguous().clone())
        self.register_buffer("icb", p["icb"].reshape(-1).clone())
        for name in ("ut", "it", "cem", "icb"):
            self.register_buffer(f"ms_{name}",
                                 torch.zeros_like(getattr(self, name)))

    def _views(self, ut, it, cem, icb) -> Dict[str, torch.Tensor]:
        kh = self.kh
        return {"ure": ut[:, :kh], "uce": ut[:, kh:], "ire": it[:, :kh],
                "irb": it[:, kh], "cem": cem, "icb": icb}

    def params(self) -> Dict[str, torch.Tensor]:
        """Views of the tables under JAX's ``_params`` keys."""
        return self._views(self.ut, self.it, self.cem, self.icb)

    def ms(self) -> Dict[str, torch.Tensor]:
        """Views of the accumulators under JAX's ``_ms`` keys."""
        return self._views(self.ms_ut, self.ms_it, self.ms_cem, self.ms_icb)

    @torch.no_grad()
    def load(self, params=None, ms=None) -> None:
        """Copy ``params`` and/or ``ms`` (dictionaries under :data:`NAMES`
        of arrays or tensors; missing names are left as they are) into the
        buffers."""
        for src, dst in ((params, self.params()), (ms, self.ms())):
            for name, view in ([] if src is None else dst.items()):
                if name not in src:
                    continue
                val = src[name]
                if not isinstance(val, torch.Tensor):
                    val = torch.from_numpy(np.asarray(val, np.float32))
                view.copy_(val.reshape(view.shape))


def _rms_dense(p: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
               lr: float) -> None:
    """Dense RMSProp in place (vbpr.py:112-114)."""
    m.mul_(0.9).add_(0.1 * g * g)
    p.sub_(lr * g / torch.sqrt(m + 1e-10))


def run_chunk(
    tables: VBPRTables,
    feat: torch.Tensor,      # [n_items, d] on the tables' device
    u_steps: torch.Tensor,   # [S, B] user rows per step
    i_steps: torch.Tensor,   # [S, B] positive items
    j_steps: torch.Tensor,   # [S, B] negative items
    hyper: Dict[str, float],
    mode: str,
) -> torch.Tensor:
    """Run ``S`` VBPR/RMSProp steps on the given triplets, updating
    ``tables`` in place; returns the summed loss as a 0-d tensor on the
    device (no host sync)."""
    b = u_steps.shape[1]
    return run_planned_steps(
        [SparseTable(tables.ut, tables.ms_ut, u_steps, (Leaf(0, b),)),
         SparseTable(tables.it, tables.ms_it,
                     torch.cat([i_steps, j_steps], 1),
                     (Leaf(0, b), Leaf(b, 2 * b)))],
        ((tables.cem, tables.ms_cem), (tables.icb, tables.ms_icb)),
        _vbpr_loss, (hyper, mode, tables.kh), apply_planned_rmsprop,
        _rms_dense, hyper["lr"],
        inputs=lambda s: (feat[i_steps[s]], feat[j_steps[s]]))


class VBPR(PairwiseRecommender):
    """Content-aware BPR with split rating/content factors.

    Defaults mirror reference vbpr.py:18 (lambda_e = 0 included);
    ``membership`` picks the sampler's store, as for ``BPR``.
    """

    SCAN_STEPS = 64  # JAX's default for VBPR

    def __init__(
        self,
        k: int,
        d: int,
        lambda_u: float = 2.5e-3,
        lambda_i: float = 2.5e-3,
        lambda_j: float = 2.5e-4,
        lambda_b: float = 0.0,
        lambda_e: float = 0.0,
        lr: float = 1.0e-4,
        mode: str = "l2",
        seed: int = 0,
        k_candidates: int = 2,
        full_k: bool = False,
        membership: str = "auto",
        device="cuda",
    ):
        super().__init__(k, lambda_u, lambda_i, lambda_j, lambda_b, lr, mode,
                         seed, k_candidates, membership, device)
        self.d = d
        self.full_k = full_k
        self.le = lambda_e
        self._feat_dev: Optional[torch.Tensor] = None
        self._pending_state: Optional[Dict[str, np.ndarray]] = None

    def set_features(self, feat) -> None:
        super().set_features(feat)
        self._feat_dev = None

    def _feat_device(self) -> torch.Tensor:
        if self._feat_dev is None:
            self._feat_dev = torch.from_numpy(self.feat).to(self.device)
        return self._feat_dev

    def hyper(self) -> Dict[str, float]:
        return {**super().hyper(), "le": self.le}

    # ---- parameter init / sync ----

    def _init_params(self, gen: torch.Generator) -> None:
        """N(0, 0.01) factors, zero biases, ``cem`` the constant 2/(d·k)
        (k, not the half width; ref vbpr.py:37-48), except for warm-start
        tables already loaded: fue's halves become ure/uce, fie[:, :kh]
        ire, fib irb (vbpr.py:321-349). A pending ``checkpoint.npz``
        restores cem, icb, irb and the accumulators exactly."""
        dev = self.device
        kh = self.k if self.full_k else self.k // 2

        def host(a):
            return torch.as_tensor(np.asarray(a, np.float32)).to(dev)

        def normal(n):
            return 0.01 * torch.randn(n, kh, generator=gen, device=dev)

        if self.fue is not None:
            ure, uce = host(self.fue[:, :kh]), host(self.fue[:, kh:2 * kh])
        else:
            ure, uce = normal(self.n_users), normal(self.n_users)
        ire = (host(self.fie[:, :kh]) if self.fie is not None
               else normal(self.n_items))
        irb = (host(self.fib).reshape(-1) if self.fib is not None
               else torch.zeros(self.n_items, device=dev))
        params = {
            "ure": ure, "uce": uce, "ire": ire, "irb": irb,
            "cem": torch.full((self.d, kh), 2.0 / (self.d * self.k),
                              device=dev),
            "icb": torch.zeros(self.d, device=dev),
        }
        self.tables = VBPRTables(params)
        if self._pending_state is not None:
            st = self._pending_state
            self.tables.load(
                params={n: st[n] for n in ("cem", "icb", "irb") if n in st},
                ms={n: st[f"ms_{n}"] for n in NAMES if f"ms_{n}" in st})
            self._pending_state = None

    def _sync_host(self) -> None:
        """Compose the whole-catalog export tables (vbpr.py:470-477)."""
        p = self.tables.params()
        F = self._feat_device()
        self.fue = self.tables.ut.cpu().numpy().copy()
        self.fie = torch.cat([p["ire"], F @ p["cem"]], 1).cpu().numpy()
        self.fib = (p["irb"] + F @ p["icb"]).reshape(-1, 1).cpu().numpy()

    # ---- training ----

    def _check_data(self) -> None:
        if self.inter is None or self.feat is None:
            raise ValueError("VBPR needs training data and features")

    def _print_header(self, epochs: int, batches: int, batch_size: int,
                      scan_steps: int) -> None:
        tprint("Training parameters: lu=%.6f, li=%.6f, lj=%.6f, "
               "lb=%.6f, le=%.6f"
               % (self.lu, self.li, self.lj, self.lb, self.le))
        tprint("Training for %d epochs of %d batches (batch %d, %d per "
               "chunk) on %s" % (epochs, batches, batch_size, scan_steps,
                                 self.device))

    def train_chunk(self, gen: torch.Generator, n_steps: int,
                    batch_size: int) -> torch.Tensor:
        """Sample and run one chunk; the summed loss stays on the device."""
        with span("train.chunk"):
            u, i, j = self.sample_chunk(gen, n_steps, batch_size)
            return run_chunk(self.tables, self._feat_device(), u, i, j,
                             self.hyper(), self.mode)

    def _release(self) -> None:
        """F leaves the device once the export tables are composed."""
        self._feat_dev = None

    # ---- native checkpoint: dense params + accumulators ----

    def _native_state(self) -> Dict[str, np.ndarray]:
        if self.tables is None:
            return {}
        p = self.tables.params()
        state = {n: p[n].cpu().numpy() for n in ("cem", "icb", "irb")}
        for name, val in self.tables.ms().items():
            state[f"ms_{name}"] = val.cpu().numpy()
        return state

    def _load_native_state(self, state) -> None:
        """Held until the next ``_init_params`` (vbpr.py:493-494)."""
        self._pending_state = state
