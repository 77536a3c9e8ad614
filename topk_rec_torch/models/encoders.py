"""Content encoders: feature -> latent mappings for DPM (counterpart of
``topk_rec_tpu/models/encoders.py``).

An encoder maps item features X [n, d] to latent vectors [n, k], fits them
for one shuffled minibatch sweep against regression targets, and may
pretrain. :class:`MLPEncoder` is the reference MLP: d -> 2000 -> 1000 -> k,
sigmoid hidden layers, a linear output, the loss 0.5·Σ w·(y − f)² (w = 0 on
the padding rows) and a hand-written RMSProp at 1e-4 with batch 64.
:class:`SDAEEncoder` adds greedy layer-wise denoising pretraining.

What the port keeps from the JAX module, value for value:

* the weights as JAX stores them: ``W{i}`` [fan_in, fan_out] and ``b{i}``
  with ``h @ W + b``, the RMSProp accumulators ``mW{i}`` and ``mb{i}``;
  ``state_dict``/``load_state_dict`` take numpy dictionaries under those
  keys, which is DPM's ``checkpoint.npz``;
* RMSProp with eps *inside* the square root, m = 0.9·m + 0.1·g², then
  p −= lr·g/sqrt(m + 1e-10) (``torch.optim.RMSprop`` puts eps outside);
* the shuffle: ``np.random.default_rng(seed)``, one permutation per sweep,
  padded with row 0 to a multiple of the batch, and SDAE's pretraining
  drawing from the same generator before ``fit`` does.

What differs: the glorot-uniform init draws from a ``torch.Generator``
seeded by ``seed`` (JAX's threefry cannot be reproduced), and the SDAE's
masking noise from a generator on the device seeded by ``seed + 1``; the
tests carry weights and masks across. Gradients come from autograd; a step's
update is a few ``torch._foreach_*`` calls, and a sweep's summed loss stays
on the device until the sweep ends. Every product is fp32 with TF32 off.

With a ``mesh`` (``set_mesh``) the fit is data-parallel (encoders.py:163-
179): each minibatch's rows are split over "dp", the parameters are
replicated, and the gradients are summed over "dp" with ``all_reduce``
before RMSProp. The shuffle is the same NumPy stream on every rank, so the
replicas stay equal; predictions and the SDAE's pretraining run whole on
every rank.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

import torch.distributed as dist

from ..device import resolve_device


class Encoder(ABC):
    """Interface: ``predict``, ``fit`` (one SGD sweep), ``pretrain``.

    Implementations may cache a device copy of the feature matrix ``X``
    keyed on the array object, so callers treat ``X`` as immutable between
    calls: to change features, pass a new array. :class:`MLPEncoder`
    spot-checks the cached array and raises on mutation in place.
    """

    @abstractmethod
    def predict(self, X: np.ndarray) -> np.ndarray: ...

    @abstractmethod
    def fit(self, X: np.ndarray, Y: np.ndarray) -> float: ...

    def pretrain(self, X: np.ndarray, Y: np.ndarray = None) -> None:
        """Optional; the reference MLP's is a no-op."""

    def state_dict(self) -> Dict[str, np.ndarray]:
        return {}

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        pass


def _forward(params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
             x: torch.Tensor) -> torch.Tensor:
    h = x
    for W, b in params[:-1]:
        h = torch.sigmoid(torch.addmm(b, h, W))
    W, b = params[-1]
    return torch.addmm(b, h, W)


def _rmsprop_(params: List[torch.Tensor], grads: List[torch.Tensor],
              ms: List[torch.Tensor], lr: float) -> None:
    """m = 0.9·m + 0.1·g², p −= lr·g/sqrt(m + 1e-10), in place
    (encoders.py:100-104, :325-326)."""
    with torch.no_grad():
        torch._foreach_mul_(ms, 0.9)
        torch._foreach_addcmul_(ms, grads, grads, value=0.1)
        denom = torch._foreach_add(ms, 1e-10)
        torch._foreach_sqrt_(denom)
        torch._foreach_addcdiv_(params, grads, denom, value=-lr)


def _fit_epoch(params, ms, X, Y, idx, row_ok, lr: float, batch_size: int,
               mesh=None):
    """One minibatch sweep over the rows ``X[idx]`` against ``Y[idx]``
    (encoders.py:63-111). ``idx`` [n_pad] is the padded permutation and
    ``row_ok`` [n_pad] its loss weights. Updates ``params`` and ``ms`` (flat
    lists [W0, b0, W1, ...]) in place; returns the summed pre-update loss as
    a 0-d tensor. With a ``mesh``, this rank takes its part of each
    minibatch's rows over "dp" and the gradients and the loss are summed
    over "dp"."""
    layers = list(zip(params[0::2], params[1::2]))
    total = torch.zeros((), dtype=torch.float32, device=X.device)
    for s in range(idx.shape[0] // batch_size):
        rows = idx[s * batch_size:(s + 1) * batch_size]
        wb = row_ok[s * batch_size:(s + 1) * batch_size]
        if mesh is not None:
            part = mesh.coords["dp"]
            rows = rows.tensor_split(mesh.shape["dp"])[part]
            wb = wb.tensor_split(mesh.shape["dp"])[part]
        xb, yb = X.index_select(0, rows), Y.index_select(0, rows)
        loss = 0.5 * (wb[:, None] * (yb - _forward(layers, xb)) ** 2).sum()
        grads = torch.autograd.grad(loss, params)
        if mesh is not None:
            for g in grads:
                dist.all_reduce(g, group=mesh.groups["dp"])
        _rmsprop_(params, list(grads), ms, lr)
        total += loss.detach()
    if mesh is not None:
        dist.all_reduce(total, group=mesh.groups["dp"])
    return total


def _dae_pretrain_epoch(params, ms, H, idx, row_ok, masks, lr: float,
                        batch_size: int, linear_out: bool):
    """One denoising-autoencoder sweep of one layer (encoders.py:286-333).

    ``params`` and ``ms`` are [W, b, Wd, bd] and their accumulators,
    updated in place; the batch s reads the rows ``H[idx[s·B:(s+1)·B]]``
    and keeps the inputs where ``masks[s]`` (bool [B, d_in]) is True. The
    masks are an argument so that a caller can feed any stream. Returns
    the summed reconstruction loss as a 0-d tensor."""
    W, b, Wd, bd = params
    total = torch.zeros((), dtype=torch.float32, device=H.device)
    for s in range(idx.shape[0] // batch_size):
        hb = H.index_select(0, idx[s * batch_size:(s + 1) * batch_size])
        wb = row_ok[s * batch_size:(s + 1) * batch_size]
        z = torch.sigmoid(torch.addmm(b, torch.where(masks[s], hb, 0.0), W))
        dec = torch.addmm(bd, z, Wd)
        if not linear_out:
            dec = torch.sigmoid(dec)
        loss = 0.5 * (wb[:, None] * (hb - dec) ** 2).sum()
        grads = torch.autograd.grad(loss, params)
        _rmsprop_(params, list(grads), ms, lr)
        total += loss.detach()
    return total


class MLPEncoder(nn.Module, Encoder):
    """Feed-forward content encoder (the reference MLP), on one device."""

    def __init__(
        self,
        k: int,
        d: int,
        lr: float = 1e-4,
        hidden_layers: Sequence[int] = (2000, 1000),
        seed: int = 0,
        batch_size: int = 64,
        device="cuda",
        mesh=None,
    ):
        """With a ``mesh`` the encoder lives on the mesh's device (``device``
        is not read) and fits data-parallel."""
        super().__init__()
        self.k = k
        self.d = d
        self.lr = lr
        self.batch_size = batch_size
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        self.mesh = None
        self._rng = np.random.default_rng(seed)
        gen = torch.Generator().manual_seed(seed)  # the same on every device
        dims = [d, *hidden_layers, k]
        self.n_layers = len(dims) - 1
        for i, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
            # glorot-uniform kernels, zero biases (tf.layers.dense defaults)
            limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
            W = (torch.rand((fan_in, fan_out), generator=gen) * 2 - 1) * limit
            setattr(self, f"W{i}", nn.Parameter(W.to(self.device)))
            setattr(self, f"b{i}", nn.Parameter(
                torch.zeros(fan_out, device=self.device)))
            self.register_buffer(f"mW{i}",
                                 torch.zeros_like(W, device=self.device))
            self.register_buffer(f"mb{i}", torch.zeros(fan_out,
                                                       device=self.device))
        self._x_cache_key = None
        self._x_cache_src = None
        self._x_cache = None
        if mesh is not None:
            self.set_mesh(mesh)

    def set_mesh(self, mesh) -> None:
        """Fit data-parallel over the mesh's "dp" axis; the encoder must
        live on the mesh's device."""
        if mesh.device != self.device:
            raise ValueError(f"the encoder lives on {self.device}, this "
                             f"rank's mesh device is {mesh.device}")
        self.mesh = mesh

    @property
    def params(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [(getattr(self, f"W{i}"), getattr(self, f"b{i}"))
                for i in range(self.n_layers)]

    @property
    def ms(self) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [(getattr(self, f"mW{i}"), getattr(self, f"mb{i}"))
                for i in range(self.n_layers)]

    def _flat(self):
        return ([t for pair in self.params for t in pair],
                [t for pair in self.ms for t in pair])

    def _feat_dev(self, X) -> torch.Tensor:
        """Device copy of the feature matrix, cached on the array object.

        DPM passes the same features to ``predict`` and ``fit`` every
        iteration (830 MB at d = 20,000 on the MovieLens catalog), so the
        copy is made once. The source array is pinned (an id is unique only
        while its object lives), and 16 strided elements are compared on
        every hit: a matrix changed in place raises instead of being scored
        stale. Tensors pass through, moved to the device."""
        if isinstance(X, torch.Tensor):
            return X.to(self.device, torch.float32)
        key = (id(X), X.shape)
        if self._x_cache_key != key:
            self._x_cache_key = key
            self._x_cache_src = X
            flat_idx = np.linspace(0, X.size - 1, num=min(16, X.size),
                                   dtype=np.int64)
            # 2-D index tuples: no copy of a non-contiguous X
            self._x_probe_idx = np.unravel_index(flat_idx, X.shape)
            self._x_probe = np.array(X[self._x_probe_idx])
            self._x_cache = torch.from_numpy(
                np.ascontiguousarray(X, dtype=np.float32)).to(
                    self.device, copy=True)
        elif not np.array_equal(X[self._x_probe_idx], self._x_probe,
                                equal_nan=True):
            raise ValueError(
                "Encoder feature matrix was mutated in place after being "
                "cached on the device; pass a new array to change features "
                "(see the Encoder docstring)")
        return self._x_cache

    def drop_feature_cache(self) -> None:
        """Release the cached device feature matrix; the next call
        uploads it again."""
        self._x_cache_key = None
        self._x_cache_src = None
        self._x_cache = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _forward(self.params, x)

    def _predict_dev(self, X) -> torch.Tensor:
        with torch.no_grad():
            return self(self._feat_dev(X))

    def predict(self, X) -> np.ndarray:
        return self._predict_dev(X).cpu().numpy()

    def _batches(self, n: int):
        """The next permutation of ``_rng`` padded with row 0 to a multiple
        of the batch, and the rows' loss weights (encoders.py:241-248)."""
        perm = self._rng.permutation(n)
        pad = (-n) % self.batch_size
        idx = np.concatenate([perm, np.zeros(pad, dtype=np.int64)])
        ok = np.zeros(n + pad, dtype=np.float32)
        ok[:n] = 1.0
        return (torch.from_numpy(idx).to(self.device),
                torch.from_numpy(ok).to(self.device))

    def _fit_sweep(self, X, Y) -> torch.Tensor:
        """One shuffled sweep; the summed loss as a 0-d device tensor."""
        Xd = self._feat_dev(X)
        Yd = torch.as_tensor(Y, dtype=torch.float32).to(self.device)
        idx, ok = self._batches(Xd.shape[0])
        params, ms = self._flat()
        return _fit_epoch(params, ms, Xd, Yd, idx, ok, self.lr,
                          self.batch_size, self.mesh)

    def fit(self, X, Y) -> float:
        """One shuffled SGD sweep; returns the summed pre-update loss."""
        return float(self._fit_sweep(X, Y))

    # ---- checkpointing, under the JAX package's keys ----

    def state_dict(self) -> Dict[str, np.ndarray]:
        state = {}
        for i, ((W, b), (mW, mb)) in enumerate(zip(self.params, self.ms)):
            for name, t in (("W", W), ("b", b), ("mW", mW), ("mb", mb)):
                state[f"{name}{i}"] = t.detach().cpu().numpy().copy()
        return state

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        with torch.no_grad():
            for i in range(self.n_layers):
                for name in ("W", "b", "mW", "mb"):
                    t = getattr(self, f"{name}{i}")
                    src = torch.from_numpy(
                        np.array(state[f"{name}{i}"], dtype=np.float32))
                    if src.shape != t.shape:
                        raise ValueError(
                            f"{name}{i}: shape {tuple(src.shape)} != "
                            f"{tuple(t.shape)}")
                    t.copy_(src)


class SDAEEncoder(MLPEncoder):
    """Stacked denoising autoencoder content encoder (CDL-style).

    The MLP's regression stack plus a real ``pretrain``: each hidden layer
    starts from a single-layer denoising autoencoder trained on the
    previous layer's clean activations, with masking noise at rate
    ``corrupt`` and a throwaway decoder (encoders.py:336-419)."""

    def __init__(
        self,
        k: int,
        d: int,
        lr: float = 1e-4,
        hidden_layers: Sequence[int] = (2000, 1000),
        seed: int = 0,
        batch_size: int = 64,
        device="cuda",
        mesh=None,
        corrupt: float = 0.3,
        pretrain_lr: float = 1e-3,
        pretrain_epochs: int = 3,
    ):
        super().__init__(k, d, lr, hidden_layers, seed, batch_size, device,
                         mesh)
        self.corrupt = corrupt
        self.pretrain_lr = pretrain_lr
        self.pretrain_epochs = pretrain_epochs
        self._mask_gen = torch.Generator(device=self.device).manual_seed(
            seed + 1)
        self.pretrain_losses: List[List[float]] = []

    def _draw_masks(self, n_batches: int, d_in: int) -> torch.Tensor:
        """One epoch's keep-masks, bool [n_batches, B, d_in]: True with
        probability 1 − corrupt."""
        u = torch.rand((n_batches, self.batch_size, d_in),
                       generator=self._mask_gen, device=self.device)
        return u < 1.0 - self.corrupt

    def pretrain(self, X, Y=None) -> None:
        """Greedy layer-wise denoising pretraining of the hidden layers; the
        output layer keeps its init (``fit`` trains it). The activations
        stay on the device, and the next layer is fed the clean ones."""
        H = self._feat_dev(X)
        self.pretrain_losses = []
        for li in range(self.n_layers - 1):
            W, b = self.params[li]
            d_in = W.shape[0]
            Wd = W.detach().T.contiguous().requires_grad_()
            bd = torch.zeros(d_in, device=self.device, requires_grad=True)
            p = [W, b, Wd, bd]
            ms = [torch.zeros_like(t) for t in p]
            losses = []
            for _ in range(self.pretrain_epochs):
                idx, ok = self._batches(H.shape[0])
                masks = self._draw_masks(idx.shape[0] // self.batch_size,
                                         d_in)
                loss = _dae_pretrain_epoch(
                    p, ms, H, idx, ok, masks, self.pretrain_lr,
                    self.batch_size, linear_out=(li == 0))
                losses.append(float(loss))
            mW, mb = self.ms[li]
            mW.zero_()
            mb.zero_()
            self.pretrain_losses.append(losses)
            with torch.no_grad():
                H = torch.sigmoid(torch.addmm(b, H, W))
