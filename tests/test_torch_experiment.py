"""The port's experiment grid and text tools: the cases of
``tests/test_experiment.py`` run on the port, and the grid's accuracies
held to the JAX package's ``run_experiment`` on the same folds.

Tolerance: the two grids train WMF from the same NumPy init (the tables
agree to rtol 1e-4, tests/test_torch_wmf_cer.py), so their rankings may
swap near-tied items: the averaged accuracies agree within one liked item
per bucket (1/count).
"""

import os

import numpy as np
import pytest

from topk_rec_tpu.data.dataset import synthetic_interactions
from topk_rec_tpu.experiment import ExperimentSpec as JaxSpec
from topk_rec_tpu.experiment import run_experiment as jax_run
from topk_rec_tpu.models import WMF as JaxWMF
from topk_rec_torch.data import Interactions
from topk_rec_torch.experiment import ExperimentSpec, run_experiment
from topk_rec_torch.models import WMF
from topk_rec_torch.tools import lda_topics, tfidf_features

N_USERS, N_ITEMS = 40, 30


@pytest.fixture(scope="module")
def grid_dir(tmp_path_factory):
    """tests/test_experiment.py:13-42: two folds, im only."""
    root = tmp_path_factory.mktemp("torch_grid")
    rng = np.random.default_rng(0)
    for fold in (0, 1):
        inter = synthetic_interactions(N_USERS, N_ITEMS, 500, seed=fold)
        uid_names = [f"u{i}" for i in range(N_USERS)]
        vid_names = [f"v{i}" for i in range(N_ITEMS)]
        (root / "uid").write_text("\n".join(uid_names) + "\n")
        (root / "vid").write_text("\n".join(vid_names) + "\n")
        indptr, flat = inter.user_csr
        lines = []
        for u in range(N_USERS):
            items = flat[indptr[u]:indptr[u + 1]]
            if len(items):
                lines.append(",".join(
                    [uid_names[u]] + [f"{vid_names[i]}:1" for i in items]))
        (root / f"f{fold}tr.txt").write_text("\n".join(lines) + "\n")
        (root / f"f{fold}te.im.idl").write_text("\n".join(vid_names) + "\n")
        telines = []
        for u in range(0, N_USERS, 3):
            liked = rng.choice(N_ITEMS, size=2, replace=False)
            telines.append(",".join(
                [uid_names[u]] + [f"{vid_names[i]}:1" for i in liked]))
        (root / f"f{fold}te.im.txt").write_text("\n".join(telines) + "\n")
    return root


def _spec(cls, spec_cls, grid_dir, out, folds, scenarios, seed=None,
          **extra):
    return spec_cls(
        data_dir=str(grid_dir),
        out_root=str(out),
        model_factory=lambda modality, fold: cls(
            k=6, seed=fold if seed is None else seed, block_size=16,
            **extra),
        train_fn=lambda model, modality, fold: model.train(max_iter=3,
                                                           verbose=False),
        modalities={"cf": None},
        folds=folds,
        scenarios=scenarios,
        step=5,
        total=10,
        **({"device": "cpu"} if spec_cls is ExperimentSpec else {}),
    )


def test_run_experiment_grid(grid_dir, tmp_path):
    spec = _spec(WMF, ExperimentSpec, grid_dir, tmp_path / "grid_out", (0, 1),
                 ("im",), device="cpu")
    result = run_experiment(spec)
    assert set(result["cells"]) == {("cf", 0), ("cf", 1)}
    for d in result["cells"].values():
        assert os.path.exists(os.path.join(d, "final-U.dat"))
    acc = result["accuracy"]["im"]["cf"]
    assert acc.shape == (2,)
    assert 0.0 <= acc[0] <= acc[1] <= 1.0
    want = jax_run(_spec(JaxWMF, JaxSpec, grid_dir, tmp_path / "jax_out",
                         (0, 1), ("im",)))
    count = 2 * len(range(0, N_USERS, 3))
    np.testing.assert_allclose(acc, want["accuracy"]["im"]["cf"], rtol=0,
                               atol=1.0 / count + 1e-12)


def test_missing_scenario_cells_do_not_deflate_average(grid_dir, tmp_path):
    """A scenario evaluated on only one fold divides by 1, not len(folds)."""
    res_one = run_experiment(_spec(WMF, ExperimentSpec, grid_dir,
                                   tmp_path / "one", (0,), ("im", "om"),
                                   seed=7, device="cpu"))
    assert "om" not in res_one["accuracy"] or not res_one["accuracy"]["om"]
    res_two = run_experiment(_spec(WMF, ExperimentSpec, grid_dir,
                                   tmp_path / "two", (0, 1), ("im",),
                                   seed=7, device="cpu"))
    acc = res_two["accuracy"]["im"]["cf"]
    assert np.all(acc <= 1.0) and np.all(acc >= 0.0)
    assert np.all(res_one["accuracy"]["im"]["cf"] > 0.0)


def test_spec_defaults_to_the_card(grid_dir, tmp_path):
    spec = _spec(WMF, ExperimentSpec, grid_dir, tmp_path, (0,), ("im",),
                 device="cpu")
    assert ExperimentSpec(spec.data_dir, spec.out_root, spec.model_factory,
                          spec.train_fn).device == "cuda"


def test_state_log(grid_dir, tmp_path):
    inter, _, _ = Interactions.from_files(
        str(grid_dir / "uid"), str(grid_dir / "vid"),
        str(grid_dir / "f0tr.txt"))
    model = WMF(k=6, seed=0, block_size=16, device="cpu")
    model.set_interactions(inter)
    log_dir = str(tmp_path / "logs")
    model.train(max_iter=3, verbose=False, log_dir=log_dir)
    settings = open(os.path.join(log_dir, "settings.txt")).read()
    assert "model = wmf" in settings and "k = 6" in settings
    lines = open(os.path.join(log_dir, "state.log")).read().splitlines()
    assert lines[0] == "iter time likelihood converge"
    assert len(lines) >= 3
    row = lines[1].split()
    assert row[0] == "0000" and float(row[2]) > 0


def test_tfidf_features():
    docs = [
        "the cat sat on the mat",
        "the dog chased the cat",
        "quantum chromodynamics lattice gauge theory",
    ]
    feat, vocab = tfidf_features(docs, vocab_size=8)
    assert feat.shape == (3, len(vocab))
    assert len(vocab) <= 8
    if "the" in vocab and "quantum" in vocab:
        assert feat[2, vocab["quantum"]] > feat[0, vocab["the"]]
    assert feat[2] @ feat[0] == 0


def test_lda_topics():
    rng = np.random.default_rng(0)
    counts = rng.integers(0, 5, size=(20, 30))
    theta, beta = lda_topics(counts, n_topics=4, max_iter=5)
    assert theta.shape == (20, 4) and beta.shape == (4, 30)
    np.testing.assert_allclose(theta.sum(axis=1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(beta.sum(axis=1), 1.0, rtol=1e-4)
