"""The port's command line (cli.py, ``python -m lightgbm_tpu_torch``)
against the JAX package's.

- ``parse_argv``, ``parse_config_file`` and ``load_all_params`` against
  the JAX functions;
- ``cli.main([..., "device=cpu"])`` in process on a .conf with the keys
  of the reference's examples/binary_classification/train.conf (a TSV
  file with a ``.weight`` side file and a validation file), and on a
  LibSVM regression file with its side files; each model held to the
  JAX package's ``lgb.train`` on the JAX ``Dataset(path)`` with the same
  parameters (``LIGHTGBM_TPU_PGROW=force``, so both take the fused
  trainer): the same split lines and header, predictions within 3e-3;
- ``task=predict`` against the JAX ``Booster.predict(path)`` of the same
  model, ``task=convert_model`` string-equal to the JAX ``model_to_cpp``
  and compiled with g++ (``PredictRaw`` within 1e-6 of the port's raw
  scores), ``task=ingest``, ``is_save_binary_file``, the snapshots, the
  checkpoint keys, ``resume``, ``report`` and ``serve`` without a model,
  and what the port refuses (other devices);
- one run of ``python -m lightgbm_tpu_torch`` as a subprocess.

The JAX package's own CLI is not run here: under jax 0.9 its
``python -m lightgbm_tpu`` fails importing ``obs/compilewatch.py``.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax._src.core

import lightgbm_tpu as lgb
from lightgbm_tpu import cli as jcli
from lightgbm_tpu.convert_model import model_to_cpp as jmodel_to_cpp

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import cli

REPO = Path(__file__).resolve().parents[1]
ROUNDS = 4

# the keys of the reference's examples/binary_classification/train.conf,
# at a test's size (num_trees, num_leaves, max_bin)
BINARY_CONF = """# task type, support train and predict
task = train
boosting_type = gbdt
objective = binary
metric = binary_logloss,auc
metric_freq = 1
is_training_metric = true
max_bin = 63
data = binary.train
valid_data = binary.test
num_trees = 4
learning_rate = 0.1
num_leaves = 15
tree_learner = serial
feature_fraction = 0.8
bagging_freq = 5
bagging_fraction = 0.8
min_data_in_leaf = 50
min_sum_hessian_in_leaf = 5.0
is_enable_sparse = true
use_two_round_loading = false
is_save_binary_file = false
output_model = LightGBM_model.txt
machine_list_file = mlist.txt
"""


@pytest.fixture(scope="module", autouse=True)
def jax_trace_state_shim():
    """jax 0.9 moved ``trace_state_clean`` out of ``jax.core``, where the
    JAX package's compile watch imports it from; put it back for the
    duration of this module."""
    had = hasattr(jax.core, "trace_state_clean")
    if not had:
        jax.core.trace_state_clean = jax._src.core.trace_state_clean
    yield
    if not had:
        del jax.core.trace_state_clean


@pytest.fixture(scope="module")
def binary_dir(tmp_path_factory):
    """binary.train / binary.test (TSV, label in column 0, a .weight side
    file for the training set) and train.conf."""
    d = tmp_path_factory.mktemp("binary_example")
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2000, 6)).round(5)
    y = (rng.random(2000) < 1 / (1 + np.exp(-(X[:, 0] - X[:, 1] + 0.5 * X[:, 2])))).astype(int)
    for name, rows in (("binary.train", slice(0, 1500)), ("binary.test", slice(1500, None))):
        np.savetxt(d / name, np.column_stack([y[rows], X[rows]]), delimiter="\t", fmt="%g")
    np.savetxt(d / "binary.train.weight", rng.random(1500).round(3) + 0.5, fmt="%g")
    (d / "train.conf").write_text(BINARY_CONF)
    return d


def _in(d, fn):
    old = os.getcwd()
    os.chdir(d)
    try:
        return fn()
    finally:
        os.chdir(old)


def _force_pgrow(fn):
    old = os.environ.get("LIGHTGBM_TPU_PGROW")
    os.environ["LIGHTGBM_TPU_PGROW"] = "force"
    try:
        return fn()
    finally:
        if old is None:
            del os.environ["LIGHTGBM_TPU_PGROW"]
        else:
            os.environ["LIGHTGBM_TPU_PGROW"] = old


def _jax_train(d, params, data, valid=None):
    """The JAX package's library on the same files and parameters."""
    def run():
        params_ = {k: v for k, v in params.items() if k not in ("num_trees", "task")}
        ds = lgb.Dataset(str(d / data), params=dict(params_))
        vs = [ds.create_valid(str(d / valid))] if valid else None
        return lgb.train(params_, ds, ROUNDS, valid_sets=vs, verbose_eval=False)
    return _force_pgrow(run)


def _split_lines(text):
    return [line for line in text.splitlines()
            if line.startswith(("Tree=", "num_leaves=", "split_feature=", "threshold=",
                                "decision_type=", "left_child=", "right_child="))]


def _tree_blocks(text):
    return text[text.index("Tree=0"):text.index("\nfeature importances:")]


@pytest.fixture(scope="module")
def binary_run(binary_dir):
    """The port's CLI trained on binary_dir (snapshots every 2
    iterations), and the JAX package's model of the same files."""
    rc = _in(binary_dir, lambda: cli.main(["config=train.conf", "device=cpu",
                                           "snapshot_freq=2"]))
    assert rc == 0
    params = cli.load_all_params([f"config={binary_dir / 'train.conf'}"])
    jb = _jax_train(binary_dir, params, "binary.train", "binary.test")
    assert jb.boosting.ptrainer is not None, "the JAX reference left the fused path"
    return (binary_dir / "LightGBM_model.txt").read_text(), jb


def test_argv_and_config_file_parse_like_jax(tmp_path):
    conf = tmp_path / "c.conf"
    conf.write_text("num_leaves = 31 # comment\n\"max_bin\"='63'\nbad line\n"
                    "num_trees=7\nlearning_rate = 0.05\n  # only a comment\n")
    argv = [f"config={conf}", "num_iterations=3", "x", "'eta'=0.2", "objective = binary"]
    for fn in ("parse_argv", "load_all_params"):
        assert getattr(cli, fn)(argv) == getattr(jcli, fn)(argv)
    assert cli.parse_config_file(str(conf)) == jcli.parse_config_file(str(conf))
    got = cli.load_all_params(argv)
    assert got["num_iterations"] == "3" and "num_trees" not in got and "eta" in got
    assert cli.parse_config_file(str(tmp_path / "missing.conf")) == {}


def test_binary_conf_model_matches_jax(binary_run, binary_dir):
    text, jb = binary_run
    jtext = jb.model_to_string()
    assert _split_lines(text) == _split_lines(jtext)
    assert text.split("Tree=0")[0] == jtext.split("Tree=0")[0]
    X = np.loadtxt(binary_dir / "binary.test")[:, 1:]
    port = lgt.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(port.predict(X), jb.predict(X), rtol=3e-3, atol=3e-4)


def test_snapshots(binary_run, binary_dir):
    text, _ = binary_run
    final = _tree_blocks(text)
    extra = final.count("Tree=") - ROUNDS  # boost_from_average's tree, if any
    for it in (2, 4):
        snap = (binary_dir / f"LightGBM_model.txt.snapshot_iter_{it}").read_text()
        blocks = _tree_blocks(snap)
        assert blocks.count("Tree=") == it + extra
        assert final.startswith(blocks)
    assert not (binary_dir / "LightGBM_model.txt.snapshot_iter_3").exists()


def test_predict_task_matches_jax(binary_run, binary_dir):
    text, _ = binary_run
    rc = _in(binary_dir, lambda: cli.main(["task=predict", "data=binary.test",
                                           "input_model=LightGBM_model.txt", "device=cpu"]))
    assert rc == 0
    lines = (binary_dir / "LightGBM_predict_result.txt").read_text().splitlines()
    want = lgb.Booster(model_file=str(binary_dir / "LightGBM_model.txt")).predict(
        str(binary_dir / "binary.test"))
    assert len(lines) == len(want) == 500
    got = np.asarray([float(v) for v in lines])
    # %g keeps six digits: the file's values are the predictions to 5e-6
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=1e-12)
    assert sum(a == f"{v:g}" for a, v in zip(lines, want)) >= 495
    # raw scores, and leaf indices (tab-separated, one column a tree)
    rc = _in(binary_dir, lambda: cli.main([
        "task=predict", "data=binary.test", "input_model=LightGBM_model.txt", "device=cpu",
        "predict_leaf_index=true", "output_result=leaves.txt"]))
    assert rc == 0
    leaves = np.loadtxt(binary_dir / "leaves.txt", delimiter="\t")
    jleaves = lgb.Booster(model_file=str(binary_dir / "LightGBM_model.txt")).predict(
        str(binary_dir / "binary.test"), pred_leaf=True)
    assert np.array_equal(leaves, jleaves)


def test_convert_model_matches_jax_and_compiles(binary_run, binary_dir, tmp_path):
    rc = _in(binary_dir, lambda: cli.main(["task=convert_model", "device=cpu",
                                           "input_model=LightGBM_model.txt",
                                           "convert_model=model.cpp"]))
    assert rc == 0
    code = (binary_dir / "model.cpp").read_text()
    jbst = lgb.Booster(model_file=str(binary_dir / "LightGBM_model.txt"))
    assert code == jmodel_to_cpp(jbst.boosting)
    so = tmp_path / "model.so"
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", str(binary_dir / "model.cpp"), "-o",
                        str(so)], check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.CalledProcessError) as e:
        pytest.skip(f"no C++ compiler: {e}")
    lib = ctypes.CDLL(str(so))
    X = np.ascontiguousarray(np.loadtxt(binary_dir / "binary.test")[:100, 1:])
    out = np.zeros(1)
    raw = np.empty(100)
    for i in range(100):
        lib.PredictRaw(X[i].ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p))
        raw[i] = out[0]
    port = lgt.Booster(model_file=str(binary_dir / "LightGBM_model.txt"), device="cpu")
    np.testing.assert_allclose(raw, port.predict(X, raw_score=True), rtol=1e-6, atol=1e-9)


def test_libsvm_regression_with_side_files_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    lines, y = [], []
    for i in range(1200):
        x = rng.standard_normal(8)
        y.append(x[0] * 2 + x[3] + 0.1 * rng.standard_normal())
        keep = rng.random(8) < 0.7
        lines.append(f"{y[-1]:.5f} " + " ".join(f"{j}:{x[j]:.5f}" for j in range(8) if keep[j]))
    (tmp_path / "reg.svm").write_text("\n".join(lines) + "\n")
    np.savetxt(tmp_path / "reg.svm.weight", rng.random(1200).round(3) + 0.5, fmt="%g")
    (tmp_path / "reg.svm.query").write_text("600\n600\n")
    conf = ("task=train\nobjective=regression\nmetric=l2\ndata=reg.svm\nnum_trees=4\n"
            "num_leaves=7\nmax_bin=31\nmin_data_in_leaf=20\nlearning_rate=0.2\n"
            "output_model=reg_model.txt\n")
    (tmp_path / "reg.conf").write_text(conf)
    assert _in(tmp_path, lambda: cli.main(["config=reg.conf", "device=cpu"])) == 0
    text = (tmp_path / "reg_model.txt").read_text()
    params = cli.load_all_params([f"config={tmp_path / 'reg.conf'}"])
    jb = _jax_train(tmp_path, params, "reg.svm")
    jtext = jb.model_to_string()
    assert _split_lines(text) == _split_lines(jtext)
    assert text.split("Tree=0")[0] == jtext.split("Tree=0")[0]
    port = lgt.Booster(model_str=text, device="cpu")
    np.testing.assert_allclose(port.predict(str(tmp_path / "reg.svm")),
                               jb.predict(str(tmp_path / "reg.svm")), rtol=3e-3, atol=3e-4)


def test_ingest_and_save_binary(binary_dir, tmp_path):
    for name in ("binary.train", "binary.train.weight", "train.conf"):
        (tmp_path / name).write_bytes((binary_dir / name).read_bytes())
    rc = _in(tmp_path, lambda: cli.main(["ingest", "data=binary.train", "max_bin=63",
                                         "stream_chunk_rows=100"]))
    assert rc == 0
    mem = lgt.Dataset(str(tmp_path / "binary.train"), params={"max_bin": 63}).construct()
    cached = lgt.Dataset(str(tmp_path / "binary.train.bin")).construct()
    assert np.array_equal(np.asarray(cached.binned), mem.binned)
    assert [m.to_string() for m in cached.bin_mappers] == [m.to_string() for m in mem.bin_mappers]
    assert np.array_equal(cached.metadata.weights, mem.metadata.weights)
    # is_save_binary_file writes the training set's cache, and training
    # from it gives the same trees
    os.remove(tmp_path / "binary.train.bin")
    argv = ["config=train.conf", "device=cpu", "valid_data=", "is_save_binary_file=true",
            "metric=auc", "num_trees=2", "snapshot_freq=-1"]
    assert _in(tmp_path, lambda: cli.main(argv)) == 0
    first = _tree_blocks((tmp_path / "LightGBM_model.txt").read_text())
    argv2 = argv[:-4] + ["data=binary.train.bin", "num_trees=2", "snapshot_freq=-1",
                         "output_model=from_cache.txt"]
    assert _in(tmp_path, lambda: cli.main(argv2)) == 0
    assert _tree_blocks((tmp_path / "from_cache.txt").read_text()) == first


@pytest.mark.parametrize("argv,match", [
    (["checkpoint_freq=2"], "checkpoint_freq"),
    (["checkpoint_dir=ck"], "checkpoint_dir"),
    (["checkpoint_resume=true"], "checkpoint_resume"),
    (["checkpoint_resume=force"], "checkpoint_resume"),
])
def test_checkpoint_keys_raise(binary_dir, tmp_path, argv, match):
    """The checkpoint keys, which raised NotImplementedError before the
    port had checkpoints, now act as in the JAX CLI: ``checkpoint_freq``
    writes checkpoints beside the model, ``checkpoint_dir`` moves them
    (at snapshot_freq when no checkpoint_freq is set), ``checkpoint_resume``
    resumes (``force`` requires a checkpoint, and raises without one).
    Tests/test_torch_ckpt_fault.py holds the resumed models."""
    for name in ("binary.train", "binary.train.weight", "binary.test"):
        (tmp_path / name).write_bytes((binary_dir / name).read_bytes())
    base = [f"config={binary_dir / 'train.conf'}", "num_trees=4", "snapshot_freq=-1",
            "output_model=m.txt"]
    if match == "checkpoint_dir":
        base[2] = "snapshot_freq=2"
    params = cli.load_all_params(base + argv)
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ckpt import CheckpointStore

    def run():
        return cli.run_train(Config.from_params(params), params, "cpu")

    if argv == ["checkpoint_resume=force"]:
        with pytest.raises(lgt.LightGBMError, match="No valid checkpoint"):
            _in(tmp_path, run)
        return
    _in(tmp_path, run)
    where = {"checkpoint_freq": tmp_path, "checkpoint_dir": tmp_path / "ck"}.get(match)
    if where is not None:
        assert CheckpointStore(str(where)).steps() == [2, 4]
        assert CheckpointStore(str(where)).complete_step() == 4
    else:
        assert not (tmp_path / "MANIFEST.json").exists()  # nothing to checkpoint
    assert (tmp_path / "m.txt").exists()


@pytest.mark.parametrize("sub", ["resume", "report", "serve", "fleet", "factory"])
def test_subcommands_not_ported_raise(sub, binary_dir, tmp_path, capsys):
    """Every subcommand runs since the port has checkpoints,
    observability, serving, the fleet and the factory: ``resume`` with no
    checkpoint fails (exit 1, "No valid checkpoint"), ``report`` without
    a trace prints its usage (exit 2), ``serve`` without a model fails
    (exit 1, "no model file"), ``fleet`` without a model, a registry or
    backends fails (exit 1, "need model="), ``factory`` without its
    workdir and registry prints its usage (exit 2)."""
    if sub == "resume":
        argv = [sub, f"data={binary_dir / 'binary.train'}", "device=cpu", "num_trees=1"]
        assert _in(tmp_path, lambda: cli.main(argv)) == 1
        assert "No valid checkpoint" in capsys.readouterr().out
        return
    if sub == "report":
        assert cli.main([sub]) == 2
        assert "usage" in capsys.readouterr().err
        return
    if sub == "serve":
        assert cli.main([sub, "data=x"]) == 1
        assert "no model file" in capsys.readouterr().out
        return
    if sub == "fleet":
        assert cli.main([sub, "data=x"]) == 1
        assert "need model=" in capsys.readouterr().out
        return
    assert cli.main([sub, "data=x"]) == 2
    assert "need data=DIR workdir=DIR registry=DIR" in capsys.readouterr().out


def test_devices(binary_dir, monkeypatch, capsys):
    base = [f"config={binary_dir / 'train.conf'}", "num_trees=1", "valid_data=",
            f"output_model={binary_dir / 'dev.txt'}", "snapshot_freq=-1"]
    assert cli.main(base + ["device=tpu"]) == 1
    assert "device=tpu" in capsys.readouterr().out
    assert cli.device_of({"device": "GPU"}) is None and cli.device_of({"device": "cuda"}) is None
    assert cli.device_of({"device": "cpu"}) == "cpu" and cli.device_of({}) is None
    # no device key: the card, which is not there
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(base) == 1
    assert "no CUDA device" in capsys.readouterr().out
    assert cli.main(["task=nonsense"]) == 1


def test_python_m_runs(binary_dir, tmp_path):
    """One subprocess run of the package's entry point."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", "lightgbm_tpu_torch",
                          f"config={binary_dir / 'train.conf'}", f"data={binary_dir}/binary.train",
                          "valid_data=", "num_trees=2", "device=cpu", "snapshot_freq=-1",
                          f"output_model={tmp_path / 'm.txt'}"],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "finished iteration 2" in out.stdout and "Finished training" in out.stdout
    assert (tmp_path / "m.txt").read_text().count("Tree=") == 2


def test_multiclass_conf_matches_jax(tmp_path):
    """A multiclass conf (B2's path on the card) and task=predict's
    tab-separated class probabilities."""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((900, 5)).round(4)
    y = np.argmax(X[:, :3] + 0.5 * rng.standard_normal((900, 3)), axis=1)
    np.savetxt(tmp_path / "mc.train", np.column_stack([y, X]), delimiter="\t", fmt="%g")
    (tmp_path / "mc.conf").write_text(
        "task=train\nobjective=multiclass\nnum_class=3\nmetric=multi_logloss\n"
        "data=mc.train\nnum_trees=2\nnum_leaves=7\nmax_bin=31\nmin_data_in_leaf=20\n"
        "output_model=mc_model.txt\n")
    assert _in(tmp_path, lambda: cli.main(["config=mc.conf", "device=cpu"])) == 0
    text = (tmp_path / "mc_model.txt").read_text()
    params = cli.load_all_params([f"config={tmp_path / 'mc.conf'}"])

    def run():
        p = {k: v for k, v in params.items() if k not in ("num_trees", "task")}
        return lgb.train(p, lgb.Dataset(str(tmp_path / "mc.train"), params=dict(p)), 2)
    jb = _force_pgrow(run)
    assert jb.boosting.ptrainer is not None, "the JAX reference left the fused path"
    assert _split_lines(text) == _split_lines(jb.model_to_string())
    rc = _in(tmp_path, lambda: cli.main(["task=predict", "data=mc.train", "device=cpu",
                                         "input_model=mc_model.txt"]))
    assert rc == 0
    got = np.loadtxt(tmp_path / "LightGBM_predict_result.txt", delimiter="\t")
    assert got.shape == (900, 3)
    np.testing.assert_allclose(got, jb.predict(X), rtol=3e-3, atol=3e-4)
