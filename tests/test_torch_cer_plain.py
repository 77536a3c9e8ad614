"""The port's ``CER.train`` against the plain float64 CER of
``tests/plain/cer.py``, from the same tables, on both E-solve routes, with
and without items nobody rated.

Each case: 300 users x 120 items, k = 8, three iterations at the
reference's settings (lu 0.01, lv 10, le 1e4, a 1, b 0.01), blocks of 64
slots. The route is the program's own choice: d = 40 ≤ n_items solves the
d x d system, d = 400 > n_items ("cg") the Woodbury form on its Cholesky
factor. With "cold" the last 20
items have no training pair, so the item half-sweep solves them from the
prior alone and the write-back replaces them by F·E.

Tolerances, each a relative gap ‖port - reference‖ / ‖reference‖ (the
iterations' losses elementwise), a few times the largest gap of the four
cases:
- the losses: 5e-6. The port's losses are float32 sums of about 3·10⁴
  terms read from ``state.log`` (11 digits); they lie within 3e-7;
- V and E: 1e-5. Float32 solves of systems the priors keep well
  conditioned (lv = 10); they lie within 1.4e-6;
- U: 3e-4. The user systems carry only lu = 0.01 on the diagonal, the
  worst conditioned of the run: float32 rounding grows by the condition
  number, and U lies within 5.2e-5.
"""

import os

import numpy as np
import pytest
import torch
from plain.cer import PlainCER

from topk_rec_torch.data import (
    Interactions,
    synthetic_features,
    synthetic_interactions,
)
from topk_rec_torch.models import CER

N_USERS, N_ITEMS, K, N_ITER, SEED = 300, 120, 8, 3, 3
HYPER = dict(lu=0.01, lv=10.0, le=1e4, a=1.0, b=0.01)
TOL = {"loss": 5e-6, "U": 3e-4, "V": 1e-5, "E": 1e-5}


def _fold(cold: bool) -> tuple:
    """(training interactions, all interactions)."""
    inter = synthetic_interactions(N_USERS, N_ITEMS, 4000, seed=11)
    if not cold:
        return inter, inter
    keep = inter.pos_i < N_ITEMS - 20
    return Interactions(N_USERS, N_ITEMS, inter.pos_u[keep],
                        inter.pos_i[keep]), inter


def _state_log_losses(log_dir: str) -> list:
    with open(os.path.join(log_dir, "state.log")) as f:
        return [float(r.split()[2]) for r in f.read().splitlines()[1:]]


def _gap(port, ref: torch.Tensor) -> float:
    ref = ref.numpy()
    return float(np.linalg.norm(np.asarray(port, np.float64) - ref)
                 / np.linalg.norm(ref))


@pytest.mark.parametrize("cold", [False, True], ids=["all-rated", "cold"])
@pytest.mark.parametrize("d,route", [(40, "direct"), (400, "cg")])
def test_cer_train_equals_plain_float64(tmp_path, d, route, cold):
    tr, inter = _fold(cold)
    feat = synthetic_features(inter, d=d, seed=5)
    model = CER(k=K, d=d, seed=SEED, block_size=64, device="cpu", **HYPER)
    model.set_interactions(tr)
    model.set_features(feat)
    U0, V0 = model.fue.copy(), model.fie.copy()
    # E as CER.train draws it when none is given
    E0 = np.random.default_rng(SEED + 17).standard_normal(
        (d, K)).astype(np.float32)
    model.train(max_iter=N_ITER, tol=0.0, verbose=False,
                log_dir=str(tmp_path))
    assert model.e_solver_steps == 0
    assert not model._e_solver_use_direct

    ref = PlainCER(torch.as_tensor(tr.pos_u), torch.as_tensor(tr.pos_i),
                   N_USERS, N_ITEMS, torch.as_tensor(feat), HYPER)
    assert ref.woodbury == (route == "cg")
    losses, U, V, E = ref.run(torch.as_tensor(U0), torch.as_tensor(V0),
                              torch.as_tensor(E0), N_ITER)
    got = _state_log_losses(str(tmp_path))
    assert len(got) == N_ITER
    loss_gap = max(abs(g - r) / abs(r) for g, r in zip(got, losses))
    gaps = {"loss": loss_gap, "U": _gap(model.fue, U),
            "V": _gap(model.fie, V), "E": _gap(model.E, E)}
    assert all(gaps[n] <= TOL[n] for n in TOL), gaps
    if cold:
        # the write-back: the cold items' rows are F·E of the final E,
        # float32 products in two summation orders
        cold_rows = np.arange(N_ITEMS - 20, N_ITEMS)
        np.testing.assert_allclose(model.fie[cold_rows],
                                   (feat @ model.E)[cold_rows], rtol=1e-5,
                                   atol=1e-5 * float(np.abs(model.fie).max()))
