"""BPR triplet sampling on the device (counterpart of
``topk_rec_tpu/ops/sampling.py``).

Each triplet (u, i, j) draws a user uniformly among the users with at least
one positive, a positive i uniformly from that user's CSR list, and a
negative j uniformly from the items the user has not liked: ``k_candidates``
uniform candidates are probed for membership and the first non-positive is
kept; the rare rows whose candidates all hit positives are redrawn one item
at a time until they miss, so every kept j is exactly uniform over the
user's negatives (the reference's rejection sampler, with no residual bias).

Two membership stores, chosen by footprint as in the JAX package:

* ``"bitmap"``: the packed positive bitmap, int32 words with the uint32
  words' bits [n_users, ceil(n_items/32)]; a probe is one gather, an
  arithmetic shift and ``& 1`` (right for bit 31 too, see
  ``ops/topk_fused.py``).
* ``"sorted"``: the int64 keys ``u·n_items + i`` of all positive pairs in
  ascending order (nnz x 8 bytes, independent of the catalog); a probe is
  one ``torch.searchsorted``. This replaces JAX's fixed-depth per-segment
  binary search (sampling.py:91-119).

Random draws come from one explicit ``torch.Generator`` on the device, in a
fixed order (users, positive offsets, candidates, redraws). Both stores see
the same memberships, so they make the same redraws and consume the
generator identically: one seed gives byte-identical triplets from either
store. The streams are not JAX's threefry streams; the tests hold the port
to the JAX sampler's distributions.

Host syncs: the rows to redraw are found with one ``nonzero``, and each
round of the redraw loop indexes by a boolean mask three times (the rows
fixed, their draws, the rows left), each a wait on the card: a call costs
1 + 3 x rounds syncs, one ``train.sync`` span each (``tracing.py``), and
one sync when no row needs a redraw. ``BPR`` samples a whole chunk of steps
in one call.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..data.dataset import Interactions
from ..device import resolve_device
from ..tracing import span

Triplets = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _below(gen: torch.Generator, high: torch.Tensor) -> torch.Tensor:
    """Uniform int64 draws in [0, high) with a per-element bound.

    ``torch.randint`` takes one scalar bound, so this draws 62 random bits
    and reduces them modulo ``high``; for the degrees of a fold (< 2^31)
    the modulo bias is below 2^-31.
    """
    bits = torch.randint(0, 2**62, high.shape, generator=gen,
                         dtype=torch.int64, device=high.device)
    return bits % high


def _bitmap_probe(pos_bitmap: torch.Tensor, u: torch.Tensor,
                  cand: torch.Tensor) -> torch.Tensor:
    """True where item ``cand`` is a positive of user ``u`` (broadcast)."""
    words = pos_bitmap[u, cand >> 5]
    return ((words >> (cand & 31)) & 1) != 0


def _sorted_probe(pos_keys: torch.Tensor, n_items: int, u: torch.Tensor,
                  cand: torch.Tensor) -> torch.Tensor:
    """True where ``u·n_items + cand`` is among the sorted positive keys."""
    q = u * n_items + cand
    at = torch.searchsorted(pos_keys, q)
    found = pos_keys[at.clamp(max=pos_keys.numel() - 1)]
    return (at < pos_keys.numel()) & (found == q)


def _sample(
    gen: torch.Generator,
    user_rows: torch.Tensor,
    flat_pos: torch.Tensor,
    batch_size: int,
    n_items: int,
    k_candidates: int,
    is_pos: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> Triplets:
    if k_candidates < 1:
        raise ValueError(f"k_candidates must be >= 1, got {k_candidates}")
    dev = user_rows.device
    uidx = torch.randint(0, user_rows.shape[0], (batch_size,), generator=gen,
                         device=dev)
    rows = user_rows[uidx]
    u, start, deg = rows[:, 0], rows[:, 1], rows[:, 2]
    i = flat_pos[start + _below(gen, deg)]
    cand = torch.randint(0, n_items, (batch_size, k_candidates),
                         generator=gen, device=dev)
    valid = ~is_pos(u[:, None], cand)
    first = torch.argmax(valid.to(torch.uint8), dim=1)  # first True column
    j = cand.gather(1, first[:, None]).squeeze(1)

    # exact rejection for the rows whose candidates were all positives;
    # each ``train.sync`` span holds one statement that waits on the card
    with span("train.sync"):
        todo = (~valid.any(dim=1)).nonzero().squeeze(1)
    while todo.numel():
        redraw = torch.randint(0, n_items, (todo.numel(),), generator=gen,
                               device=dev)
        ok = ~is_pos(u[todo], redraw)
        with span("train.sync"):
            fixed = todo[ok]
        with span("train.sync"):
            j[fixed] = redraw[ok]
        with span("train.sync"):
            todo = todo[~ok]
    return u, i, j


def sample_triplets(
    gen: torch.Generator,
    user_rows: torch.Tensor,   # int64 [n_tr_users, 3]: user, CSR start, degree
    flat_pos: torch.Tensor,    # int64 [nnz]
    pos_bitmap: torch.Tensor,  # int32 [n_users, ceil(n_items/32)]
    batch_size: int,
    n_items: int,
    k_candidates: int = 2,
) -> Triplets:
    """``batch_size`` triplets (u, i, j), int64, through the bitmap store."""
    return _sample(gen, user_rows, flat_pos, batch_size, n_items,
                   k_candidates,
                   lambda u, c: _bitmap_probe(pos_bitmap, u, c))


def sample_triplets_sorted(
    gen: torch.Generator,
    user_rows: torch.Tensor,   # int64 [n_tr_users, 3]: user, CSR start, degree
    flat_pos: torch.Tensor,    # int64 [nnz]
    pos_keys: torch.Tensor,    # int64 [nnz], ascending u·n_items + i
    batch_size: int,
    n_items: int,
    k_candidates: int = 2,
) -> Triplets:
    """As :func:`sample_triplets`, through the sorted-key store; the same
    generator state gives the same triplets."""
    return _sample(gen, user_rows, flat_pos, batch_size, n_items,
                   k_candidates,
                   lambda u, c: _sorted_probe(pos_keys, n_items, u, c))


class TripletSampler:
    """Device sampler bound to one fold's membership store.

    ``membership``: ``"bitmap"`` | ``"sorted"`` | ``"auto"`` (default).
    Auto keeps the dense bitmap while it fits ``bitmap_budget_bytes``
    (1 GiB; MovieLens needs about 87 MB) and takes the sorted keys beyond
    (sampling.py:193-243). The store lives on ``device``, the card unless
    the caller asks for the CPU.
    """

    def __init__(
        self,
        inter: Interactions,
        k_candidates: int = 2,
        membership: str = "auto",
        bitmap_budget_bytes: int = 1 << 30,
        device="cuda",
    ):
        if membership not in ("auto", "bitmap", "sorted"):
            raise ValueError(
                f"membership must be auto|bitmap|sorted, got {membership!r}")
        dev = resolve_device(device)
        indptr, flat = inter.user_csr
        tr = np.asarray(inter.rated_users, dtype=np.int64)
        rows = np.stack([tr, np.asarray(indptr, np.int64)[tr],
                         np.asarray(inter.user_deg, np.int64)[tr]], axis=1)
        self.user_rows = torch.from_numpy(rows).to(dev)
        self.flat_pos = torch.from_numpy(flat.astype(np.int64)).to(dev)
        if membership == "auto":
            bitmap_bytes = inter.n_users * ((inter.n_items + 31) // 32) * 4
            membership = ("bitmap" if bitmap_bytes <= bitmap_budget_bytes
                          else "sorted")
        self.membership = membership
        if membership == "bitmap":
            words = np.ascontiguousarray(inter.pos_bitmap).view(np.int32)
            self.pos_bitmap = torch.from_numpy(words).to(dev)
        else:
            keys = np.unique(inter.pos_u.astype(np.int64) * inter.n_items
                             + inter.pos_i.astype(np.int64))
            self.pos_keys = torch.from_numpy(keys).to(dev)
        self.n_items = inter.n_items
        self.k_candidates = k_candidates

    def __call__(self, gen: torch.Generator, batch_size: int) -> Triplets:
        if self.membership == "sorted":
            return sample_triplets_sorted(
                gen, self.user_rows, self.flat_pos, self.pos_keys,
                batch_size, self.n_items, self.k_candidates)
        return sample_triplets(
            gen, self.user_rows, self.flat_pos, self.pos_bitmap, batch_size,
            self.n_items, self.k_candidates)

    def sample_numpy(self, gen: torch.Generator, batch_size: int):
        return tuple(t.cpu().numpy() for t in self(gen, batch_size))
