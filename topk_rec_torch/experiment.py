"""Multi-fold x multi-modality experiment grid (counterpart of
``topk_rec_tpu/experiment.py``).

The reference's grid workflow trains one model per (modality, fold),
exports it and evaluates each scenario, then averages over folds. Here a
typed spec drives the library: each cell's tables are exported in the
standard ``.dat`` layout under ``<out_root>/<modality><fold>/``, so fusion
and the reference CLI read them unchanged, and evaluated through the port's
``DeviceEvaluator`` on ``spec.device``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from .data import Interactions, load_id_map
from .device import resolve_device
from .eval.device import DeviceEvaluator
from .eval.protocol import load_test_likes
from .utils import tprint


@dataclass
class ExperimentSpec:
    data_dir: str
    out_root: str
    model_factory: Callable[[str, int], object]
    """(modality_name, fold) -> fresh model instance."""
    train_fn: Callable[[object, str, int], None]
    """(model, modality_name, fold) -> trains the model in place."""
    modalities: Dict[str, Optional[np.ndarray]] = field(default_factory=dict)
    """modality name -> aligned feature matrix (None for pure-CF models)."""
    folds: Sequence[int] = (0,)
    scenarios: Sequence[str] = ("im", "om")
    step: int = 5
    total: int = 30
    device: str = "cuda"
    """where the evaluator scores; the models bring their own device."""


def run_experiment(spec: ExperimentSpec) -> Dict:
    """Train and evaluate the grid; returns the per-cell export dirs and the
    accuracy per (scenario, modality) averaged over the folds that had that
    scenario's files (a missing cell is skipped, not averaged as zero):

      {"cells": {(modality, fold): dir},
       "accuracy": {scenario: {modality: np.ndarray [interval]}}}
    """
    device = resolve_device(spec.device)
    uids = load_id_map(os.path.join(spec.data_dir, "uid"))
    iids = load_id_map(os.path.join(spec.data_dir, "vid"))
    acc_sums: Dict[str, Dict[str, np.ndarray]] = {
        s: {} for s in spec.scenarios}
    acc_counts: Dict[str, Dict[str, int]] = {s: {} for s in spec.scenarios}
    cells: Dict = {}
    for fold in spec.folds:
        inter, _, _ = Interactions.from_files(
            os.path.join(spec.data_dir, "uid"),
            os.path.join(spec.data_dir, "vid"),
            os.path.join(spec.data_dir, f"f{fold}tr.txt"),
        )
        evaluator = DeviceEvaluator(inter.seen_bitmap, step=spec.step,
                                    total=spec.total, device=device)
        for modality, feat in spec.modalities.items():
            tprint(f"[experiment] fold {fold} modality {modality}")
            model = spec.model_factory(modality, fold)
            model.set_interactions(inter, uids, iids)
            if feat is not None:
                model.set_features(feat)
            spec.train_fn(model, modality, fold)
            out_dir = os.path.join(spec.out_root, f"{modality}{fold}")
            model.export_embeddings(out_dir)
            cells[(modality, fold)] = out_dir
            for scenario in spec.scenarios:
                idl = os.path.join(spec.data_dir, f"f{fold}te.{scenario}.idl")
                txt = os.path.join(spec.data_dir, f"f{fold}te.{scenario}.txt")
                if not (os.path.exists(idl) and os.path.exists(txt)):
                    tprint(
                        f"[experiment] WARNING: fold {fold} scenario "
                        f"{scenario} files missing — cell skipped (excluded "
                        "from the average)")
                    continue
                cand_map = load_id_map(idl)
                cand_ids = np.empty(len(cand_map), dtype=np.int64)
                for cid, pos in cand_map.items():
                    cand_ids[pos] = iids[cid]
                likes = load_test_likes(txt, uids, cand_map)
                res = evaluator.evaluate(model.fue, model.fie, model.fib,
                                         cand_ids, likes)
                prev = acc_sums[scenario].setdefault(
                    modality, np.zeros(spec.total // spec.step))
                prev += res.accuracy
                acc_counts[scenario][modality] = (
                    acc_counts[scenario].get(modality, 0) + 1)
    accuracy = {
        s: {m: v / acc_counts[s][m] for m, v in per_mod.items()}
        for s, per_mod in acc_sums.items()
    }
    return {"cells": cells, "accuracy": accuracy}
