"""Jax-free home of the protocol's result type and test-fold parser.

Counterparts of ``topk_rec_tpu/eval/protocol.py:28-38`` (``EvalResult``)
and ``:99-122`` (``load_test_likes``). That module stays the specification
(its ``evaluate_oracle`` is what the tests hold the port against), but its
package ``__init__`` imports the jax evaluator, so the port cannot import it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..data import io as _io
from ..tracing import span


@dataclass
class EvalResult:
    hits: np.ndarray      # float [interval] summed hit counts per bucket
    rr: np.ndarray        # float [interval] summed reciprocal ranks per bucket
    count: int            # total number of liked test items (denominator)

    @property
    def accuracy(self) -> np.ndarray:
        if self.count == 0:
            return np.zeros_like(self.hits)
        return self.hits / self.count


def load_test_likes(
    test_file: str,
    uids: Dict[str, int],
    cand_ids: Dict[str, int],
) -> Dict[int, List[int]]:
    """Parse a test fold file into user -> liked-candidate-index lists:
    entries with like == 1 whose item is in the scenario's candidate list
    (reference evaluate.py:84-93).

    The port's C++ parser reads the file when it is built; the loop below
    is its specification, and reads a file the C++ side leaves to it."""
    with span("io.test_likes"):
        native = _io._native_lib()
        parsed = None if native is None else native.parse_likes(
            test_file, uids, cand_ids)
        if parsed is not None:
            users, offsets, pos = parsed
            # the map's own value objects: fewer ints to make, collect, free
            values = np.array(list(cand_ids.values()), dtype=object)
            items, offs = values[pos].tolist(), offsets.tolist()
            return {u: items[a:b]
                    for u, a, b in zip(users.tolist(), offs, offs[1:])}
        likes: Dict[int, List[int]] = {}
        with span("io.test_likes_python"), open(test_file, "r") as f:
            for line in f:
                terms = line.strip().split(",")
                uid = terms[0]
                if uid not in uids:
                    continue
                cur: List[int] = []
                for term in terms[1:]:
                    iid, _, like = term.partition(":")
                    if like == "1" and iid in cand_ids:
                        cur.append(cand_ids[iid])
                likes[uids[uid]] = cur
        return likes
