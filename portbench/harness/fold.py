"""The seeded fold of a configuration, and its text files.

A fold is made from ``--seed`` at the configuration's own scale:

* each user rates ``min_user_pairs`` items plus a share of the rest of
  ``n_pairs`` drawn from a lognormal of ``user_activity_sigma``, capped at
  ``max_user_pairs`` (the sum is exactly ``n_pairs``);
* a user's items are drawn without replacement with zipf weights
  ``(rank + 1) ** -zipf_exponent`` over a seeded popularity order, by
  Gumbel keys sorted on the device in blocks of users (the popularity law
  of ``bench.py``'s folds, without its folding modulo the catalog);
* fold 0's out-of-matrix items are every fifth item of the popularity
  order (ranks 4, 9, 14, ...), the first ``n_om_items`` of them, so that
  they hold about a fifth of the pairs whatever the seed; their pairs are
  the om test likes;
* of each user's other pairs, one in ``im_holdout`` (rounded down), chosen
  at random, is an im test like, and the rest are the training pairs;
* every pair is liked (``liked_share`` 1: implicit feedback).

:func:`write_fold_text` writes the reference's text formats: ``uid`` and
``vid`` (ids ``u<n>`` and ``i<n>`` in index order), ``f0tr.txt`` and
``f0te.<scenario>.txt`` (``uid,iid:1,iid:1,...``) and
``f0te.<scenario>.idl`` (one candidate id a line), and :func:`write_dat`
the ``final-*.dat`` tables (``%f`` values, a space before the newline).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .seeds import generator, rng

USER_BLOCK = 4096  # users whose Gumbel keys are sorted at once


@dataclass
class Fold:
    n_users: int
    n_items: int
    train_u: np.ndarray   # int64, sorted by user, then item
    train_i: np.ndarray
    im_u: np.ndarray      # held-out in-matrix likes, sorted the same way
    im_i: np.ndarray
    om_u: np.ndarray      # likes of the out-of-matrix items
    om_i: np.ndarray
    im_items: np.ndarray  # the in-matrix candidates, ascending
    om_items: np.ndarray  # the out-of-matrix candidates, ascending

    def scenario(self, name: str):
        """(candidate items, liked users, liked items) of ``im`` or ``om``."""
        if name == "im":
            return self.im_items, self.im_u, self.im_i
        if name == "om":
            return self.om_items, self.om_u, self.om_i
        raise ValueError(f"unknown scenario {name!r}")


def user_counts(cfg: dict, seed: int) -> np.ndarray:
    """Pairs per user: the minimum plus a capped lognormal share of the
    rest, summing to exactly ``n_pairs``."""
    n_u, total = cfg["n_users"], cfg["n_pairs"]
    lo, cap = cfg["min_user_pairs"], cfg["max_user_pairs"] - cfg["min_user_pairs"]
    if not lo * n_u <= total <= (lo + cap) * n_u:
        raise ValueError("n_pairs does not fit the per-user bounds")
    r = rng(seed, "users")
    w = r.lognormal(0.0, cfg["user_activity_sigma"], n_u)
    extra = np.zeros(n_u)
    free = np.ones(n_u, bool)
    left = float(total - lo * n_u)
    while True:
        share = np.where(free, left * w / w[free].sum(), 0.0)
        over = free & (share > cap)
        if not over.any():
            break
        extra[over] = cap
        free &= ~over
        left -= cap * int(over.sum())
    extra = np.where(free, share, extra)
    base = np.minimum(np.floor(extra).astype(np.int64), cap)
    rest = total - lo * n_u - int(base.sum())
    room = np.flatnonzero(base < cap)
    base[r.permutation(room)[:rest]] += 1
    return lo + base


def popularity(cfg: dict, seed: int):
    """(item of each popularity rank, log zipf weight of each item)."""
    n_i = cfg["n_items"]
    item_of_rank = rng(seed, "fold").permutation(n_i)
    logw = np.empty(n_i)
    logw[item_of_rank] = -cfg["zipf_exponent"] * np.log1p(np.arange(n_i))
    return item_of_rank, logw


def draw_pairs(cfg: dict, seed: int, counts: np.ndarray, logw: np.ndarray,
               device) -> tuple:
    """(users, items) of every rated pair on ``device``, sorted by user
    then item: each user's top ``counts[u]`` items by zipf log-weight plus
    Gumbel noise."""
    dev = torch.device(device)
    g = generator(seed, "fold", dev)
    lw = torch.as_tensor(logw, dtype=torch.float32, device=dev)
    cnt = torch.as_tensor(counts, device=dev)
    us, its = [], []
    for start in range(0, cfg["n_users"], USER_BLOCK):
        stop = min(start + USER_BLOCK, cfg["n_users"])
        # a Gumbel draw is -log of an exponential draw
        expo = torch.empty(stop - start, lw.numel(), device=dev)
        keys = lw - expo.exponential_(generator=g).log_()
        order = torch.sort(keys, dim=1, descending=True, stable=True).indices
        c = cnt[start:stop]
        width = int(c.max())
        take = torch.arange(width, device=dev)[None, :] < c[:, None]
        rows = torch.arange(start, stop, device=dev)[:, None].expand(-1, width)
        us.append(rows[take])
        its.append(order[:, :width][take])
    key = torch.sort(torch.cat(us) * lw.numel() + torch.cat(its)).values
    return key // lw.numel(), key % lw.numel()


def make_fold(cfg: dict, seed: int, device) -> Fold:
    """The fold of ``cfg`` for ``seed``, its pairs drawn on ``device``."""
    n_u, n_i = cfg["n_users"], cfg["n_items"]
    counts = user_counts(cfg, seed)
    item_of_rank, logw = popularity(cfg, seed)
    u, i = draw_pairs(cfg, seed, counts, logw, device)
    om_items = np.sort(item_of_rank[np.arange(4, n_i, 5)[:cfg["n_om_items"]]])
    is_om = torch.zeros(n_i, dtype=torch.bool, device=u.device)
    is_om[torch.as_tensor(om_items, device=u.device)] = True
    om = is_om[i]
    wu, wi = u[~om], i[~om]
    # one in im_holdout of each user's in-matrix pairs, at random: sort
    # each user's pairs by a random key, hold out the first ones
    g = generator(seed, "holdout", u.device)
    key = torch.randint(0, 2**31, wu.shape, generator=g, device=u.device)
    order = torch.sort(wu * 2**31 + key).indices
    per_user = torch.bincount(wu, minlength=n_u)
    starts = torch.cumsum(per_user, 0) - per_user
    rank = torch.empty_like(wu)
    rank[order] = torch.arange(wu.numel(), device=u.device) - starts[wu[order]]
    held = rank < (per_user // cfg["im_holdout"])[wu]

    def host(t):
        return t.cpu().numpy()

    return Fold(n_u, n_i, host(wu[~held]), host(wi[~held]), host(wu[held]),
                host(wi[held]), host(u[om]), host(i[om]),
                np.flatnonzero(~is_om.cpu().numpy()), om_items)


def make_tables(n_users: int, n_items: int, d: int, seed: int, device,
                scale: float = 0.3, bias_scale: float = 0.1):
    """Served or evaluated tables: U, V ~ N(0, scale²), a bias
    ~ N(0, bias_scale²), fp32 on ``device``, in one call each."""
    g = generator(seed, "tables", device)
    U = scale * torch.randn(n_users, d, generator=g, device=device)
    V = scale * torch.randn(n_items, d, generator=g, device=device)
    B = bias_scale * torch.randn(n_items, generator=g, device=device)
    return U, V, B


def _likes_text(u: np.ndarray, i: np.ndarray, n_users: int,
                n_items: int) -> bytes:
    """``u<n>,i<m>:1,...`` lines of the (user-sorted) pairs, one a user."""
    if u.size == 0:
        return b""
    users, starts, counts = np.unique(u, return_index=True,
                                      return_counts=True)
    terms = np.array([b",i%d:1" % n for n in range(n_items)], dtype=object)
    uids = np.array([b"u%d" % n for n in range(n_users)], dtype=object)
    k = np.arange(users.size)
    tokens = np.empty(u.size + 2 * users.size, dtype=object)
    tokens[np.arange(u.size) + 2 * np.repeat(k, counts) + 1] = terms[i]
    tokens[starts + 2 * k] = uids[users]
    tokens[starts + counts + 2 * k + 1] = b"\n"
    return b"".join(tokens.tolist())


def write_fold_text(fold: Fold, root: str) -> None:
    """The fold in the reference's text formats under ``root``."""
    os.makedirs(root, exist_ok=True)

    def put(name, data: bytes):
        with open(os.path.join(root, name), "wb") as f:
            f.write(data)

    put("uid", b"".join(b"u%d\n" % n for n in range(fold.n_users)))
    put("vid", b"".join(b"i%d\n" % n for n in range(fold.n_items)))
    put("f0tr.txt", _likes_text(fold.train_u, fold.train_i, fold.n_users,
                                fold.n_items))
    for name in ("im", "om"):
        cand, lu, li = fold.scenario(name)
        put(f"f0te.{name}.txt", _likes_text(lu, li, fold.n_users,
                                            fold.n_items))
        put(f"f0te.{name}.idl", b"".join(b"i%d\n" % n for n in cand))


def round6(a: np.ndarray) -> np.ndarray:
    """float32 values with six decimals, which ``%f`` text keeps exactly."""
    return np.round(np.asarray(a, np.float64), 6).astype(np.float32)


def write_dat(path: str, mat: np.ndarray) -> None:
    """A ``final-*.dat`` table: ``%f`` values, a space before the newline."""
    mat = np.asarray(mat, np.float32)
    if mat.ndim == 1:
        mat = mat.reshape(-1, 1)
    row = " ".join(["%f"] * mat.shape[1]) + " \n"
    with open(path, "w") as f:
        f.write("".join(row % tuple(r) for r in mat.tolist()))


def make_features(cfg: dict, seed: int, device) -> torch.Tensor:
    """Item features [n_items, d]: word counts made on ``device``. Each
    item has ``topic_words`` words of the topic of its popularity place
    x = log10(1 + rank) (topic t owns words 100·t .. 100·t + 99; a word
    comes from topic floor(x) with probability 1 - frac(x), else from the
    next) and ``noise_words`` words drawn from the whole vocabulary; a
    word drawn twice counts twice."""
    n_i, d = cfg["n_items"], cfg["d"]
    tw, nw = cfg["topic_words"], cfg["noise_words"]
    item_of_rank, _ = popularity(cfg, seed)
    rank = np.empty(n_i, np.int64)
    rank[item_of_rank] = np.arange(n_i)
    x = torch.as_tensor(np.log10(1.0 + rank), device=device)
    g = generator(seed, "features", device)
    lo = torch.floor(x).long()
    up = torch.rand(n_i, tw, generator=g, device=device) < (x - lo)[:, None]
    topic = lo[:, None] + up.long()
    words = torch.cat([
        topic * 100 + torch.randint(0, 100, (n_i, tw), generator=g,
                                    device=device),
        torch.randint(0, d, (n_i, nw), generator=g, device=device)], 1)
    feat = torch.zeros(n_i, d, device=device)
    rows = torch.arange(n_i, device=device)[:, None].expand_as(words)
    feat.index_put_((rows.reshape(-1), words.reshape(-1) % d),
                    torch.ones(words.numel(), device=device), accumulate=True)
    return feat
