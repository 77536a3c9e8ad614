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

import json
import os
import pickle
import re

import numpy as np
import pytest

from topk_rec_tpu import cli as jax_cli
from topk_rec_tpu.data import load_id_map
from topk_rec_tpu.data.dataset import synthetic_interactions
from topk_rec_tpu.data.io import write_dat
from topk_rec_torch import cli as torch_cli

CONTENT_D = 64  # feature width of the fold's meta.pkl


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
    # item features in vid order, wider than the catalog (the Woodbury route)
    with open(root / "meta.pkl", "wb") as f:
        pickle.dump(rng.normal(size=(n_items, CONTENT_D)).astype(np.float32),
                    f)
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


TIMING_PHASES = ["fold_parse", "dat_parse", "im_inputs", "im_eval",
                 "om_inputs", "om_eval", "total"]


def _timing_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith("timing: ")]


@pytest.mark.parametrize("timing", [True, False])
def test_evaluate_tkr_timing_phases(fold_dir, model_dir, capsys, monkeypatch,
                                    timing):
    """TKR_TIMING=1 prints JAX's phase names in JAX's order on stderr, one
    ``timing: <name> <s>s`` line each; unset, no timing line. The CSV on
    stdout is the same either way."""
    if timing:
        monkeypatch.setenv("TKR_TIMING", "1")
    else:
        monkeypatch.delenv("TKR_TIMING", raising=False)
    args = ["evaluate", "-d", str(fold_dir), "-m", str(model_dir), "-f", "0",
            "-sl", "im", "om"]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr()
    assert torch_cli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.out.startswith("im,")
    lines = _timing_lines(got.err)
    names = [ln.split()[1] for ln in lines]
    assert names == [ln.split()[1] for ln in _timing_lines(want.err)]
    assert names == (TIMING_PHASES if timing else [])
    for ln in lines:
        assert re.fullmatch(r"timing: \w+ \d+\.\d\ds", ln), ln


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


def test_train_refuses_an_orbax_ckpt_dir(fold_dir, tmp_path, capsys):
    """A --ckpt-dir that the JAX package filled through orbax stops the run
    with exit code 2 and a message naming the flag for a fresh run,
    instead of training from epoch 0 beside the JAX steps."""
    from topk_rec_tpu.checkpoint import CheckpointManager as JaxCheckpoints

    ck = tmp_path / "ck"
    tree = {"params": {"ue": np.ones((4, 2), np.float32)}}
    assert JaxCheckpoints(str(ck)).save(1, tree)
    with pytest.raises(SystemExit) as ei:
        torch_cli.main(["train", "--model", "bpr", "-d", str(fold_dir),
                        "--k", "4", "--epochs", "2", "--device", "cpu",
                        "-o", str(tmp_path / "out"), "--ckpt-dir", str(ck)])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    assert "orbax" in err and "--ckpt-dir" in err
    assert not (tmp_path / "out").exists()
    assert os.listdir(ck) == ["step_00000001"]


@pytest.mark.parametrize("extra,message", [
    (["--model", "bpr", "--mesh", "2x4"], "needs 8 ranks"),
    (["--model", "cer", "--mesh", "2x4"], "needs 8 ranks"),
])
def test_train_unported_exits_2(fold_dir, tmp_path, capsys, extra, message):
    """A --mesh that the process group cannot hold (2x4 in one process)
    exits 2 with the reason, before anything is trained or written."""
    with pytest.raises(SystemExit) as ei:
        torch_cli.main(["train", *extra, "-d", str(fold_dir), "-o",
                        str(tmp_path / "out"), "--device", "cpu"])
    assert ei.value.code == 2
    assert message in capsys.readouterr().err
    assert not (tmp_path / "out").exists()


DPM_FLAGS = ["--content", "meta.pkl", "--d", str(CONTENT_D), "--max-iter",
             "2", "--encoder-hidden", "32", "16", "--save-lag", "1"]
DPM_FILES = ["0000-U.dat", "0000-V.dat", "0001-U.dat", "0001-V.dat",
             "checkpoint.npz", "final-U.dat", "final-V.dat", "settings.txt",
             "state.log"]

# per case (the model, then any variant): its own flags, and the files both
# CLIs write for them
TRAIN_CASES = {
    "vbpr": (["--content", "meta.pkl", "--d", str(CONTENT_D), "--epochs",
              "2", "--batch-size", "64", "--lr", "0.05"],
             ["checkpoint.npz", "final-B.dat", "final-U.dat", "final-V.dat"]),
    "wmf": (["--max-iter", "4"], ["final-U.dat", "final-V.dat"]),
    "cer": (["--content", "meta.pkl", "--d", str(CONTENT_D), "--max-iter",
             "3", "--als-le", "100", "--save-lag", "1"],
            ["0000-U.dat", "0000-V.dat", "0001-U.dat", "0001-V.dat",
             "0002-U.dat", "0002-V.dat", "final-E.dat", "final-U.dat",
             "final-V.dat", "settings.txt", "state.log"]),
    "dpm": (DPM_FLAGS, DPM_FILES),
    "dpm-sdae": (DPM_FLAGS + ["--encoder", "sdae"], DPM_FILES),
}


@pytest.mark.parametrize("model", sorted(TRAIN_CASES))
def test_train_content_and_als_models(fold_dir, tmp_path, capsys, model):
    """``train --model {vbpr,wmf,cer,dpm} --device cpu`` (DPM with both
    encoders) writes the files that the JAX CLI's ``train`` writes, and the
    JAX CLI's ``evaluate`` reads the port's tables into the CSV that the
    port's prints (both engines)."""
    flags, files = TRAIN_CASES[model]
    model = model.split("-")[0]
    outs = {}
    for name, cli, extra in (("port", torch_cli, ["--device", "cpu"]),
                             ("jax", jax_cli, [])):
        out = tmp_path / name
        log = ["--log-dir", str(out)] if model in ("cer", "dpm") else []
        assert cli.main(["train", "--model", model, "-d", str(fold_dir),
                         "-o", str(out), "--k", "6", *flags, *log,
                         *extra]) == 0
        assert sorted(os.listdir(out)) == files, name
        outs[name] = out
    capsys.readouterr()
    V = np.loadtxt(outs["port"] / "final-V.dat")
    assert V.shape[0] == 50 and np.isfinite(V).all()
    args = ["evaluate", "-d", str(fold_dir), "-m", str(outs["port"]),
            "-sl", "im", "om"]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert want.startswith("im,") and "\nom," in want
    for engine in ("torch", "kernel"):
        assert torch_cli.main(args + ["--engine", engine, "--device",
                                      "cpu"]) == 0
        assert capsys.readouterr().out == want, engine


@pytest.mark.parametrize("extra", [
    ["--model", "cer", "--theta-init", "theta.dat"],
    ["--model", "vbpr"],
    ["--model", "cer"],
])
def test_train_refusals_word_for_word(fold_dir, tmp_path, extra):
    """--theta-init is for wmf only and --content is required for the
    content models: the port refuses with the JAX CLI's own message."""
    codes = []
    for cli, dev in ((jax_cli, []), (torch_cli, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as ei:
            cli.main(["train", *extra, "-d", str(fold_dir), "-o",
                      str(tmp_path / "out"), "--k", "4", *dev])
        codes.append(ei.value.code)
    assert codes[0] == codes[1]
    assert isinstance(codes[1], str) and codes[1].startswith("--")


def test_train_profile_dir_writes_a_trace(fold_dir, tmp_path):
    prof = tmp_path / "prof"
    assert torch_cli.main([
        "train", "--model", "wmf", "-d", str(fold_dir), "-o",
        str(tmp_path / "out"), "--k", "4", "--max-iter", "2",
        "--profile-dir", str(prof), "--device", "cpu"]) == 0
    with open(prof / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("cholesky" in n for n in names), sorted(names)[:20]
    # BPR's chunk spans show in the trace too
    assert torch_cli.main([
        "train", "--model", "bpr", "-d", str(fold_dir), "-o",
        str(tmp_path / "bpr"), "--k", "4", "--epochs", "1",
        "--profile-dir", str(prof), "--device", "cpu"]) == 0
    with open(prof / "trace.json") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert {"tkr.train.chunk", "tkr.train.sample", "tkr.train.sync",
            "tkr.train.step", "tkr.train.grad"} <= names


@pytest.fixture(scope="module")
def fuse_dirs(tmp_path_factory):
    """Three modalities of widths 6, 4 and 8 with continuous tables (no
    tied scores, so both packages rank the same items)."""
    rng = np.random.default_rng(31)
    dirs = []
    for k in (6, 4, 8):
        mdir = tmp_path_factory.mktemp(f"torch_cli_fuse{k}")
        write_dat(str(mdir / "final-U.dat"),
                  rng.normal(size=(60, k)).astype(np.float32))
        write_dat(str(mdir / "final-V.dat"),
                  rng.normal(size=(50, k)).astype(np.float32))
        dirs.append(str(mdir))
    return dirs


@pytest.mark.parametrize("flags", [["average"], ["rank"],
                                   ["rank", "--p", "0.3"], ["error"],
                                   ["rank", "--p-sweep"]],
                         ids=["average", "rank", "rank-p0.3", "error",
                              "p-sweep"])
def test_fuse_lines_equal_jax(fold_dir, fuse_dirs, capsys, flags):
    """``fuse`` prints the JAX CLI's lines byte for byte: one
    ``strategy-scenario`` line per scenario, or nine ``rank-pX-scenario``
    lines per scenario with --p-sweep."""
    args = ["fuse", "--strategy", *flags, "-d", str(fold_dir), "-m",
            *fuse_dirs, "-sl", "im", "om"]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    assert torch_cli.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want
    lines = got.splitlines()
    assert len(lines) == (18 if "--p-sweep" in flags else 2)
    assert lines[0].startswith("rank-p0.1-im," if "--p-sweep" in flags
                               else f"{flags[0]}-im,")


@pytest.mark.parametrize("strategy", ["svm", "bpr"])
def test_fuse_learned_weights_lines(fold_dir, fuse_dirs, capsys, strategy):
    """The learned weightings draw their own triplets: their lines are
    well-formed, accuracies in [0, 1] and rising with the cut-off."""
    assert torch_cli.main(["fuse", "--strategy", strategy, "-d",
                           str(fold_dir), "-m", *fuse_dirs, "-sl", "im", "om",
                           "--n-samples", "4000", "--seed", "3", "--device",
                           "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(",")[0] for ln in lines] == [f"{strategy}-im",
                                                  f"{strategy}-om"]
    for ln in lines:
        acc = np.array(ln.split(",")[1:], float)
        assert acc.shape == (6,) and np.all((acc >= 0) & (acc <= 1))
        assert np.all(np.diff(acc) >= 0)
        assert all(len(c.split(".")[1]) == 6 for c in ln.split(",")[1:])
