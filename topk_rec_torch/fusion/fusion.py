"""Late score fusion of per-modality models (counterpart of
``topk_rec_tpu/fusion/fusion.py``).

The reference's five strategies over per-modality score matrices:

* average        — uniform weights (afusion.py:26-31);
* rank-geometric — w_i = p·(1-p)^i over the modality list (pfusion.py:64-70);
* error-weighted — per-user exp(−(RMSE − mean)) from the train-set
                   reconstruction error (efusion.py:57-82);
* svm            — a squared-hinge linear SVM on pairwise score
                   differences (sfusion.py:28-63), fitted by full-batch Adam;
* bpr            — a pairwise-ranking weight vector over the score
                   differences (ranking_fusion.py:19-62), by minibatch SGD.

The modality scores are made on the device one user chunk at a time; the
dense [n_users, n_cand, F] tensor the reference builds never exists.
Evaluation folds the weights into one product per chunk, Σ_f w_f·U_f·V_fᵀ
= [w_f·U_f]·[V_f]ᵀ, and ranks it with ``topk_unseen_scorer``. These are
XLA code in the JAX package, outside any Pallas kernel, so their products
here are ``torch.matmul`` (fp32, TF32 off) and their loops plain PyTorch.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Interactions
from ..device import resolve_device
from ..eval.device import _count_hits, topk_unseen_scorer
from ..eval.protocol import EvalResult
from ..ops.sampling import TripletSampler
from ..ops.topk_fused import bitmap_tensor


class ModalityScores:
    """Per-modality embeddings on one device, scored chunk by chunk.

    Modality f contributes S_f = U_f · V_f[cand]ᵀ; widths may differ
    between modalities."""

    def __init__(self, embeddings: Sequence[Tuple[np.ndarray, np.ndarray]],
                 device="cuda"):
        """``embeddings``: list of (U_f [n_users, k_f], V_f [n_items, k_f])."""
        if not embeddings:
            raise ValueError("ModalityScores needs at least one modality")
        self.device = resolve_device(device)
        self.n_feats = len(embeddings)
        self.n_users = embeddings[0][0].shape[0]
        self.n_items = embeddings[0][1].shape[0]
        self._U = [self._tensor(U) for U, _ in embeddings]
        self._V = [self._tensor(V) for _, V in embeddings]

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.float32)).to(
            self.device)

    def _index(self, ids) -> torch.Tensor:
        if isinstance(ids, torch.Tensor):
            return ids.to(self.device, torch.int64)
        return torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(
            self.device)

    def chunk_stack(self, start: int, stop: int, cand_ids) -> torch.Tensor:
        """[stop - start, n_cand, F] stacked scores of a user range."""
        cand = self._index(cand_ids)
        return torch.stack([U[start:stop] @ V[cand].T
                            for U, V in zip(self._U, self._V)], dim=-1)

    def sample_scores(self, u: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        """S[u, i, :] for paired index vectors: [B, F]."""
        return torch.stack([(U[u] * V[i]).sum(1)
                            for U, V in zip(self._U, self._V)], dim=-1)

    def fused_scorer(self, weights: np.ndarray, cand_ids):
        """Chunk scorer of the weighted fusion as one concatenated product:
        Σ_f w_f·U_f·V_fᵀ = concat_f(w_f·U_f) · concat_f(V_f)ᵀ, for global
        [F] and per-user [n_users, F] weights (fusion.py:81-123)."""
        w = self._tensor(weights)
        cand = self._index(cand_ids)
        V_cat = torch.cat([V[cand] for V in self._V], dim=1)
        if w.dim() == 1:
            U_cat = torch.cat([w[f] * U for f, U in enumerate(self._U)],
                              dim=1)

            def scorer(start, stop):
                return U_cat[start:stop] @ V_cat.T
        else:
            def scorer(start, stop):
                wc = w[start:stop]
                U_cat = torch.cat([wc[:, f:f + 1] * U[start:stop]
                                   for f, U in enumerate(self._U)], dim=1)
                return U_cat @ V_cat.T
        return scorer


# ---------------------------------------------------------------------------
# weight strategies


def average_weights(n_feats: int) -> np.ndarray:
    """Uniform late fusion (ref afusion.py:26-31)."""
    return np.full(n_feats, 1.0 / n_feats, dtype=np.float32)


def rank_geometric_weights(n_feats: int, p: float) -> np.ndarray:
    """w_i = p·(1-p)^i over the modality list order (ref pfusion.py:64-70)."""
    i = np.arange(n_feats)
    return (np.power(1.0 - p, i) * p).astype(np.float32)


def error_weights(
    modalities: ModalityScores,
    inter: Interactions,
    cand_ids: np.ndarray,
    user_chunk: int = 4096,
) -> np.ndarray:
    """Per-user error-based weights (ref efusion.py:57-82, fusion.py:141-197).

    weight[u, f] = sqrt(Σ_c (S_f[u,c] − L[u,c])²·L[u,c] / max(1, Σ_c L[u,c]))
    with L the 0/1 train likes in candidate space, expanded on the device
    from the packed positive bitmap chunk by chunk; then per user the row
    mean is subtracted and exp(−·) taken, and a row whose mean is exactly 0
    stays at zero. Every chunk is queued before the weights are fetched.
    """
    dev = modalities.device
    cand = np.asarray(cand_ids, dtype=np.int64)
    bm_dev = bitmap_tensor(inter.pos_bitmap, dev)
    cw = torch.from_numpy(cand >> 5).to(dev)
    cb = torch.from_numpy((cand & 31).astype(np.int32)).to(dev)
    cand_dev = torch.from_numpy(cand).to(dev)
    chunks = []
    for start in range(0, modalities.n_users, user_chunk):
        stop = min(start + user_chunk, modalities.n_users)
        stack = modalities.chunk_stack(start, stop, cand_dev)
        like = ((bm_dev[start:stop][:, cw] >> cb) & 1).to(torch.float32)
        sq = (stack - like[:, :, None]) ** 2 * like[:, :, None]
        svec = torch.clamp(like.sum(1), min=1.0)
        chunks.append(torch.sqrt(sq.sum(1) / svec[:, None]))
    weight = torch.cat(chunks).cpu().numpy()
    wmean = weight.mean(axis=1, keepdims=True)
    nz = (wmean != 0).reshape(-1)
    weight[nz] = np.exp(-(weight[nz] - wmean[nz]))
    return weight


def _squared_hinge_fit(X: torch.Tensor, y: torch.Tensor, C: float,
                       lr: float, n_iters: int):
    """min_w 0.5‖w‖² + C·Σ max(0, 1 − y(Xw + b))² by full-batch Adam
    (fusion.py:200-232): eps outside the square root, bias correction at
    t + 1. Returns (w, the loss after the last update)."""
    def grads(w, b):
        margin = torch.clamp(1.0 - y * (X @ w + b), min=0.0)
        coef = -2.0 * C * margin * y
        return w + X.T @ coef, coef.sum()

    def loss_fn(w, b):
        margin = torch.clamp(1.0 - y * (X @ w + b), min=0.0)
        return 0.5 * (w ** 2).sum() + C * (margin ** 2).sum()

    F = X.shape[1]
    p = [torch.zeros(F, device=X.device), torch.zeros((), device=X.device)]
    m = [torch.zeros_like(t) for t in p]
    v = [torch.zeros_like(t) for t in p]
    for t in range(n_iters):
        g = list(grads(*p))
        torch._foreach_mul_(m, 0.9)
        torch._foreach_add_(m, g, alpha=0.1)
        torch._foreach_mul_(v, 0.999)
        torch._foreach_addcmul_(v, g, g, value=0.001)
        # the JAX scan's float32 arithmetic for the bias corrections
        c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(t + 1))
        c2 = float(np.float32(1) - np.float32(0.999) ** np.float32(t + 1))
        denom = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, 1e-8)
        step = torch._foreach_div(m, c1)
        torch._foreach_mul_(step, lr)
        torch._foreach_div_(step, denom)
        torch._foreach_sub_(p, step)
    return p[0], loss_fn(*p)


def svm_fusion_weights(
    modalities: ModalityScores,
    inter: Interactions,
    n_samples: int = 100_000,
    C: float = 0.01,
    seed: int = 0,
    lr: float = 0.05,
    n_iters: int = 500,
) -> np.ndarray:
    """Linear-SVM fusion weights on pairwise difference vectors
    (ref sfusion.py:28-63, fusion.py:235-260): (user, liked, disliked)
    triplets from the device sampler, features S[u,i,:] − S[u,j,:], labels
    alternating ±1 with the −1 rows negated, and a squared-hinge fit."""
    dev = modalities.device
    sampler = TripletSampler(inter, device=dev)
    u, i, j = sampler(torch.Generator(device=dev).manual_seed(seed),
                      n_samples)
    x = modalities.sample_scores(u, i) - modalities.sample_scores(u, j)
    sign = torch.where(torch.arange(n_samples, device=dev) % 2 == 0, 1.0,
                       -1.0)
    w, _ = _squared_hinge_fit(x * sign[:, None], sign, C, lr, n_iters)
    return w.cpu().numpy()


def _fusion_build_d(Ucat, Vcat, u, i, j, n_chunks: int, widths,
                    n_batches: int, batch_size: int) -> torch.Tensor:
    """Score differences for the bpr-fusion fit (fusion.py:263-303): per
    chunk of triplets, the row gathers Ucat[u]·(Vcat[i] − Vcat[j]) over the
    concatenated tables, reduced by each modality's own column segment, so
    modalities of different widths stay apart. Returns [n_batches,
    batch_size, F]."""
    offsets = np.concatenate([[0], np.cumsum(widths)])
    gchunk = u.shape[0] // n_chunks
    parts = []
    for c in range(n_chunks):
        sl = slice(c * gchunk, (c + 1) * gchunk)
        g = Ucat[u[sl]] * (Vcat[i[sl]] - Vcat[j[sl]])
        parts.append(torch.stack([g[:, offsets[f]:offsets[f + 1]].sum(1)
                                  for f in range(len(widths))], dim=-1))
    return torch.cat(parts).view(n_batches, batch_size, len(widths))


def _fusion_sgd(d_all: torch.Tensor, w0: torch.Tensor, lr: float,
                lambda_w: float):
    """Minibatch SGD over the precomputed batches (fusion.py:306-320, the
    loss of ref ranking_fusion.py:28-37): per batch d, the cost
    −Σ log σ(d·w) + 0.5·λw·‖w‖² and w −= lr·∇. Returns (w, the pre-update
    cost of every batch)."""
    w = w0.clone()
    costs = []
    for d in d_all:
        x = d @ w
        costs.append(-torch.nn.functional.logsigmoid(x).sum()
                     + 0.5 * lambda_w * (w ** 2).sum())
        g = -(d.T @ torch.sigmoid(-x)) + lambda_w * w
        w = w - lr * g
    return w, torch.stack(costs)


def bpr_fusion_weights(
    modalities: ModalityScores,
    inter: Interactions,
    n_samples: int = 10_000_000,
    batch_size: int = 10_000,
    lr: float = 1.0e-4,
    lambda_w: float = 0.0025,
    seed: int = 0,
) -> np.ndarray:
    """Pairwise-ranking fusion weights (ref ranking_fusion.py:19-62,
    fusion.py:323-375): W starts at zero; plain SGD on
    −Σ log σ(W·(S[u,i,:] − S[u,j,:])) + λw/2·‖W‖² over batches of 10k
    sampled triplets, the reference's 10M by default. The differences do
    not depend on W, so they are computed before the SGD chain."""
    dev = modalities.device
    sampler = TripletSampler(inter, device=dev)
    F = modalities.n_feats
    n_batches = max(1, n_samples // batch_size)
    total = n_batches * batch_size
    n_gather_chunks = max(1, min(n_batches, 40))
    while total % n_gather_chunks:
        n_gather_chunks -= 1
    u, i, j = sampler(torch.Generator(device=dev).manual_seed(seed), total)
    Ucat = torch.cat(modalities._U, dim=1)   # [n_users, Σ k_f]
    Vcat = torch.cat(modalities._V, dim=1)   # [n_items, Σ k_f]
    d_all = _fusion_build_d(Ucat, Vcat, u, i, j, n_gather_chunks,
                            tuple(int(U.shape[1]) for U in modalities._U),
                            n_batches, batch_size)
    w, _ = _fusion_sgd(d_all, torch.zeros(F, device=dev), lr, lambda_w)
    return w.cpu().numpy()


# ---------------------------------------------------------------------------
# fused evaluation


def evaluate_fused(
    modalities: ModalityScores,
    weights: np.ndarray,
    seen_bitmap: np.ndarray,
    cand_ids: np.ndarray,
    likes: Dict[int, Sequence[int]],
    step: int = 5,
    total: int = 30,
    user_chunk: int = 4096,
    packed_seen: np.ndarray = None,
    want_rr: bool = False,
) -> EvalResult:
    """The weighted fusion under the standard protocol (fusion.py:382-424).

    ``weights`` is [F] (global strategies) or [n_users, F] (error
    fusion). ``packed_seen`` (host words, or device words from
    ``candidate_words``) lets a caller that evaluates several strategies
    on one scenario pack the candidate-space seen bitmap once.
    ``want_rr`` is off by default: the fusion surfaces print accuracy only.
    """
    weights = np.asarray(weights, dtype=np.float32)
    n_cand = len(np.asarray(cand_ids))
    vals, idx, seen_above = topk_unseen_scorer(
        modalities.fused_scorer(weights, cand_ids), modalities.n_users,
        n_cand, seen_bitmap, cand_ids, total, user_chunk,
        packed_seen=packed_seen, want_rr=want_rr, device=modalities.device,
    )
    return _count_hits(idx, vals, seen_above, likes, n_cand, step, total)
