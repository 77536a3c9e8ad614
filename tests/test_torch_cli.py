"""``python -m topk_rec_torch.cli`` against ``topk_rec_tpu.cli`` on one fold.

``train`` runs on the CPU (``--device cpu``); the CSV that ``evaluate``
prints for the tables it trained must be the JAX CLI's, byte for byte.

The exported tables hold multiples of 1/64 below 4 in magnitude: they are
exact in the ``%f`` text format and in bf16, and every product and sum of
the scores is exact in fp32. Both packages therefore rank the same exact
numbers (ties included, lowest index first), so the evaluate CSV must be
byte-identical and recommend must return the same items; the printed
scores agree within 1e-5 (one unit of the sixth printed decimal).
"""

import numpy as np
import pytest

from topk_rec_tpu import cli as jax_cli
from topk_rec_tpu.data import load_id_map
from topk_rec_tpu.data.dataset import synthetic_interactions
from topk_rec_tpu.data.io import write_dat
from topk_rec_torch import cli as torch_cli


@pytest.fixture(scope="module")
def fold_dir(tmp_path_factory):
    """A tests/test_cli.py-style fold: string ids != indices, im and om."""
    root = tmp_path_factory.mktemp("torch_cli_fold")
    rng = np.random.default_rng(0)
    n_users, n_items = 60, 50
    inter = synthetic_interactions(n_users, n_items, 1200, seed=6)
    uid_names = [f"u{i}" for i in range(n_users)]
    vid_names = [f"v{i}" for i in range(n_items)]
    (root / "uid").write_text("\n".join(uid_names) + "\n")
    (root / "vid").write_text("\n".join(vid_names) + "\n")
    indptr, flat = inter.user_csr
    lines = []
    for u in range(n_users):
        items = flat[indptr[u]:indptr[u + 1]]
        if len(items):
            lines.append(
                ",".join([uid_names[u]] + [f"{vid_names[i]}:1" for i in items])
            )
    (root / "f0tr.txt").write_text("\n".join(lines) + "\n")
    (root / "f0te.im.idl").write_text("\n".join(vid_names) + "\n")
    telines = []
    for u in range(0, n_users, 2):
        liked = rng.choice(n_items, size=2, replace=False)
        telines.append(
            ",".join([uid_names[u]] + [f"{vid_names[i]}:1" for i in liked])
        )
    (root / "f0te.im.txt").write_text("\n".join(telines) + "\n")
    om_cand = list(range(n_items - 8, n_items))[::-1]  # arbitrary order
    (root / "f0te.om.idl").write_text(
        "\n".join(vid_names[i] for i in om_cand) + "\n"
    )
    omlines = []
    for u in range(0, n_users, 3):
        liked = rng.choice(om_cand, size=2, replace=False)
        omlines.append(
            ",".join([uid_names[u]] + [f"{vid_names[i]}:1" for i in liked])
        )
    (root / "f0te.om.txt").write_text("\n".join(omlines) + "\n")
    return root


def _quantized(rng, shape):
    return (np.clip(np.round(rng.normal(size=shape) * 48), -255, 255)
            / 64).astype(np.float32)


@pytest.fixture(scope="module")
def model_dir(fold_dir, tmp_path_factory):
    mdir = tmp_path_factory.mktemp("torch_cli_model")
    rng = np.random.default_rng(21)
    write_dat(str(mdir / "final-U.dat"), _quantized(rng, (60, 6)))
    write_dat(str(mdir / "final-V.dat"), _quantized(rng, (50, 6)))
    write_dat(str(mdir / "final-B.dat"), _quantized(rng, (50, 1)))
    return mdir


@pytest.mark.parametrize("engine", ["torch", "kernel"])
@pytest.mark.parametrize("buckets", [[], ["-s", "3", "-t", "9"]])
def test_evaluate_csv_byte_identical(fold_dir, model_dir, capsys, engine,
                                     buckets):
    args = ["evaluate", "-d", str(fold_dir), "-m", str(model_dir), "-f", "0",
            "-sl", "im", "om", *buckets]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert torch_cli.main(args + ["--engine", engine, "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert got.startswith("im,") and "\nom," in got


# with 50 items, approx_max_k does not reduce (XLA reduces only rows of
# more than 128), so the approx method is exact here too
@pytest.mark.parametrize("method", ["exact", "kernel", "hybrid", "approx"])
def test_recommend_same_items(fold_dir, model_dir, tmp_path, capsys, method):
    users = list(load_id_map(str(fold_dir / "uid")))[:7]
    ufile = tmp_path / "users.txt"
    ufile.write_text("\n".join(users[3:]) + "\n")
    common = ["recommend", "-d", str(fold_dir), "-m", str(model_dir),
              "-k", "9", "--users-file", str(ufile), *users[:3]]
    assert jax_cli.main(common + ["--method", "exact"]) == 0
    want = capsys.readouterr().out.strip().splitlines()
    assert torch_cli.main(common + ["--method", method,
                                    "--device", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        g_user, *g_cells = g.split(",")
        w_user, *w_cells = w.split(",")
        assert g_user == w_user
        assert [c.split(":")[0] for c in g_cells] == \
            [c.split(":")[0] for c in w_cells]
        np.testing.assert_allclose(
            [float(c.split(":")[1]) for c in g_cells],
            [float(c.split(":")[1]) for c in w_cells], atol=1e-5,
        )


def test_friendly_errors(fold_dir, tmp_path, capsys):
    with pytest.raises(SystemExit) as ei:
        torch_cli.main(["evaluate", "-d", str(fold_dir), "-m",
                        str(tmp_path / "nope"), "--device", "cpu"])
    assert ei.value.code == 2
    assert "does not exist" in capsys.readouterr().err
    with pytest.raises(SystemExit) as ei:
        torch_cli.main(["recommend", "-d", str(fold_dir), "-m", str(tmp_path),
                        "--device", "cpu", "nosuchuser"])
    assert ei.value.code == 2


@pytest.fixture(scope="module")
def trained_dir(fold_dir, tmp_path_factory):
    """A BPR trained by the port's ``train`` on the CPU."""
    out = tmp_path_factory.mktemp("torch_cli_bpr")
    assert torch_cli.main([
        "train", "--model", "bpr", "-d", str(fold_dir), "-o", str(out),
        "--k", "8", "--epochs", "2", "--batch-size", "64", "--lr", "0.05",
        "--device", "cpu"]) == 0
    return out


def test_train_writes_the_model_files(trained_dir, capsys):
    for name in ("final-U.dat", "final-V.dat", "final-B.dat",
                 "checkpoint.npz"):
        assert (trained_dir / name).exists(), name
    U = np.loadtxt(trained_dir / "final-U.dat")
    assert U.shape == (60, 8) and np.isfinite(U).all()
    with np.load(trained_dir / "checkpoint.npz") as data:
        assert sorted(data.files) == ["ms_ib", "ms_ie", "ms_ue"]
        assert data["ms_ie"].shape == (50, 8)


@pytest.mark.parametrize("engine", ["torch", "kernel"])
def test_evaluate_port_trained_model_same_csv(fold_dir, trained_dir, capsys,
                                              engine):
    """evaluate on the port-trained tables prints the JAX CLI's CSV."""
    args = ["evaluate", "-d", str(fold_dir), "-m", str(trained_dir),
            "-sl", "im", "om"]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert torch_cli.main(args + ["--engine", engine, "--device",
                                  "cpu"]) == 0
    assert capsys.readouterr().out == want


def test_train_resumes_from_ckpt_dir(fold_dir, tmp_path, capsys):
    """Rerunning the same command with --ckpt-dir resumes: two runs to 2
    epochs, the second starting from the first's checkpoint, write the
    tables of one straight run."""
    common = ["train", "--model", "bpr", "-d", str(fold_dir), "--k", "4",
              "--batch-size", "64", "--lr", "0.05", "--device", "cpu"]
    ck = str(tmp_path / "ck")
    torch_cli.main(common + ["-o", str(tmp_path / "a"), "--epochs", "2"])
    torch_cli.main(common + ["-o", str(tmp_path / "b"), "--epochs", "1",
                             "--ckpt-dir", ck])
    torch_cli.main(common + ["-o", str(tmp_path / "b"), "--epochs", "2",
                             "--ckpt-dir", ck])
    assert "Resuming from checkpointed epoch 1" in capsys.readouterr().out
    for name in ("final-U.dat", "final-V.dat", "final-B.dat"):
        assert (tmp_path / "a" / name).read_text() == \
            (tmp_path / "b" / name).read_text()


@pytest.mark.parametrize("extra,message", [
    (["--model", "wmf"], "not yet ported"),
    (["--model", "vbpr"], "not yet ported"),
    (["--model", "bpr", "--mesh", "2x4"], "not yet ported"),
])
def test_train_unported_exits_2(fold_dir, tmp_path, capsys, extra, message):
    with pytest.raises(SystemExit) as ei:
        torch_cli.main(["train", *extra, "-d", str(fold_dir), "-o",
                        str(tmp_path / "out"), "--device", "cpu"])
    assert ei.value.code == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
