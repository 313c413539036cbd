"""lightgbm_tpu_torch stands alone: it and the chip scripts at the repo
root import torch and numpy, never jax or the JAX package (nor pandas,
scipy or scikit-learn, which the card machine lacks: they load only when
given their objects); it builds its kernels lazily, and its entry points
refuse to fall back to the CPU silently."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "lightgbm_tpu_torch"


def test_new_modules_pull_in_no_optional_packages():
    """The API modules import with no jax, pandas, scipy or sklearn, and a
    numpy-only run through them loads none of those either."""
    code = ("import sys, numpy as np, lightgbm_tpu_torch as lgt, lightgbm_tpu_torch.sklearn, "
            "lightgbm_tpu_torch.boosting.dart, lightgbm_tpu_torch.boosting.pred_early_stop, "
            "lightgbm_tpu_torch.engine, lightgbm_tpu_torch.callback, lightgbm_tpu_torch.cli, "
            "lightgbm_tpu_torch.data, lightgbm_tpu_torch.native, lightgbm_tpu_torch.pmml, "
            "lightgbm_tpu_torch.plotting, lightgbm_tpu_torch.convert_model, "
            "lightgbm_tpu_torch.serve.server; "
            "from lightgbm_tpu_torch.serve import PackedPredictor, PredictorArtifact; "
            "X = np.random.default_rng(0).standard_normal((300, 4)); y = (X[:, 0] > 0) * 1.0; "
            "p = dict(objective='binary', num_leaves=4, verbose=-1); "
            "b = lgt.train(p, lgt.Dataset(X, label=y), 2, device='cpu'); "
            "lgt.cv(p, lgt.Dataset(X, label=y), 1, nfold=2, device='cpu'); "
            "lgt.LGBMClassifier(n_estimators=1, device='cpu').fit(X, y).predict(X); "
            "b.predict(X, pred_leaf=True); "
            "PackedPredictor(PredictorArtifact.from_booster(b, quantized=True, "
            "leaf_dtype='bfloat16'), device='cpu').predict(X); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'lightgbm_tpu', 'pandas', 'scipy', 'sklearn', 'matplotlib', 'graphviz', "
            "'triton')]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_import_pulls_in_no_jax():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.engine, "
            "lightgbm_tpu_torch.convert, lightgbm_tpu_torch.ops.pkernels, "
            "lightgbm_tpu_torch.cli, lightgbm_tpu_torch.data.ingest, lightgbm_tpu_torch.native, "
            "lightgbm_tpu_torch.pmml, lightgbm_tpu_torch.plotting, "
            "lightgbm_tpu_torch.ops.grow, lightgbm_tpu_torch.ops.histogram, "
            "lightgbm_tpu_torch.ops.qhist, lightgbm_tpu_torch.boosting.goss, "
            "lightgbm_tpu_torch.ckpt, lightgbm_tpu_torch.obs.report, "
            "lightgbm_tpu_torch.obs.metrics, lightgbm_tpu_torch.obs.audit, "
            "lightgbm_tpu_torch.utils.profiling, lightgbm_tpu_torch.serve.server, "
            "lightgbm_tpu_torch.ops.qpredict; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'lightgbm_tpu' or m.startswith('lightgbm_tpu.')]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_transport_imports_with_jax_blocked():
    """The multi-process transport (parallel/net.py, distributed.py,
    collect.py) imports and runs its one-process paths with jax and the
    JAX package made unimportable."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'lightgbm_tpu'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "from lightgbm_tpu_torch.parallel import net, distributed, collect, NetComm\n"
            "assert distributed.process_count() == 1 and not distributed.ensure_initialized()\n"
            "assert collect.allgather_bytes(b'x') == [b'x']\n"
            "assert net.parse_fault_spec('die:2') == [('die', 2.0)]\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("LIGHTGBM_TPU_COORDINATOR", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|lightgbm_tpu)(?:[\s.]|$)", re.M)


# the scripts at the repo root that run the port on the card
CHIP_SCRIPTS = ["chip_ab.py", "chip_smoke.py"]


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in PKG.rglob("*.py")) + CHIP_SCRIPTS)
def test_no_file_imports_jax(path):
    src = (REPO / path).read_text()
    assert not IMPORT_RE.search(src), f"{path} imports jax or lightgbm_tpu"


def test_kernel_sources_present():
    names = {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert {"update_hist.cu", "partition_hist.cu", "score_add.cu", "update_multi_hist.cu",
            "segment_hist.cu", "update_channels.cu"} <= names


def test_train_without_device_raises_when_no_card(monkeypatch):
    import lightgbm_tpu_torch as lgt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).standard_normal((200, 3))
    y = (X[:, 0] > 0).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lgt.train({"objective": "binary"}, lgt.Dataset(X, label=y), 1)


NO_CARD_CALLS = {
    "cv": lambda lgt, X, y: lgt.cv({"objective": "binary"}, lgt.Dataset(X, label=y), 1,
                                   nfold=2),
    "init_model": lambda lgt, X, y: lgt.train(
        {"objective": "binary"}, lgt.Dataset(X, label=y), 1,
        init_model=lgt.train({"objective": "binary"}, lgt.Dataset(X, label=y), 1,
                             device="cpu")),
    "LGBMRegressor": lambda lgt, X, y: lgt.LGBMRegressor(n_estimators=1).fit(X, y),
    "LGBMClassifier": lambda lgt, X, y: lgt.LGBMClassifier(n_estimators=1).fit(X, y),
    "LGBMRanker": lambda lgt, X, y: lgt.LGBMRanker(n_estimators=1).fit(X, y, group=[200]),
    "__setstate__": lambda lgt, X, y: lgt.Booster.__new__(lgt.Booster).__setstate__(
        dict(lgt.train({"objective": "binary"}, lgt.Dataset(X, label=y), 1,
                       device="cpu").__getstate__(), device="cuda")),
}


@pytest.mark.parametrize("name", list(NO_CARD_CALLS))
def test_new_entry_points_raise_when_no_card(name, monkeypatch):
    """With device=None (the card) and no card, the API's entry points
    raise instead of running on the CPU."""
    import lightgbm_tpu_torch as lgt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).standard_normal((200, 3))
    y = (X[:, 0] > 0).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NO_CARD_CALLS[name](lgt, X, y)


def test_data_files_pull_in_no_optional_packages(tmp_path):
    """A CSV and a LibSVM file parsed (native library), streamed, cached
    and trained on, and the CLI's train and predict tasks, load no jax,
    pandas, matplotlib or graphviz."""
    code = ("import sys, numpy as np, lightgbm_tpu_torch as lgt; "
            "from lightgbm_tpu_torch import cli; "
            "p = dict(objective='binary', num_leaves=4, verbose=-1); "
            "lgt.Dataset('d.csv', params={'stream_ingest': 'true'}).save_binary('d.bin'); "
            "b = lgt.train(p, lgt.Dataset('d.bin'), 2, device='cpu'); b.predict('d.csv'); "
            "lgt.Dataset('d.svm').construct(); "
            "assert cli.main(['data=d.csv', 'num_trees=2', 'device=cpu', 'verbose=-1']) == 0; "
            "assert cli.main(['task=predict', 'data=d.csv', 'input_model=LightGBM_model.txt', "
            "'device=cpu']) == 0; "
            "from lightgbm_tpu_torch.data.reader import parser_blocks; "
            "assert parser_blocks().get('native'), parser_blocks(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'lightgbm_tpu', 'pandas', 'scipy', 'matplotlib', 'graphviz', 'triton')]; "
            "assert not bad, bad; print('ok')")
    X = np.random.default_rng(0).standard_normal((300, 4))
    np.savetxt(tmp_path / "d.csv", np.column_stack([X[:, 0] > 0, X]), delimiter=",", fmt="%g")
    (tmp_path / "d.svm").write_text("".join(
        f"{int(r[0] > 0)} " + " ".join(f"{j}:{v:g}" for j, v in enumerate(r) if v > -0.5) + "\n"
        for r in X))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("LIGHTGBM_TPU_NO_NATIVE", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_path_entry_points_raise_when_no_card(monkeypatch, tmp_path):
    """A Dataset from a file trains on the card by default, and the
    card's absence raises; a prediction of a file does too."""
    import lightgbm_tpu_torch as lgt

    X = np.random.default_rng(0).standard_normal((200, 3))
    np.savetxt(tmp_path / "d.csv", np.column_stack([X[:, 0] > 0, X]), delimiter=",", fmt="%g")
    model = lgt.train({"objective": "binary", "verbose": -1}, lgt.Dataset(str(tmp_path / "d.csv")),
                      1, device="cpu").model_to_string()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lgt.train({"objective": "binary"}, lgt.Dataset(str(tmp_path / "d.csv")), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lgt.Booster(model_str=model).predict(str(tmp_path / "d.csv"))


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    from lightgbm_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_wrappers_count_no_launch_on_cpu():
    from lightgbm_tpu_torch.ops import pkernels as pk

    pk.reset_launch_counts()
    lay = pk.PLayout(5)
    p = pk.pack_matrix(np.zeros((100, 5), np.uint8), lay)
    pk.score_add(p, lay, np.ones(100, np.float32), num_rows=100)
    pk.hist_dyn(p, 0, 100, 5, 4)
    pk.hist_segments(p, np.asarray([[0, 60], [60, 40]]), 2, num_features=5, num_bins=4, smax=2)
    pk.update_channels(p, lay, _L2(), delta=np.ones(100, np.float32), num_rows=100)
    pk.hist_segment(p, 0, 100, 5, 4)
    pk.hist_segment_q(p, 10, 90, 5, 4)
    assert pk.launch_counts() == {"update_and_root_hist": 0, "update_multi_and_hists": 0,
                                  "level_stream": 0, "split_stream": 0, "score_add": 0,
                                  "hist_dyn": 0, "hist_segments": 0, "update_channels": 0,
                                  "hist_segment": 0, "hist_segment_q": 0,
                                  "split_stream_rows": 0, "hist_segment_rows": 0,
                                  "hist_segment_q_rows": 0}
    assert float(pk.f32_row(p, lay.SCORE, 100).sum()) == 200.0
    assert float(pk.f32_row(p, lay.G, 100).sum()) == 200.0  # L2: g = score - label


class _L2:
    """Unweighted L2 gradients, enough for the wrapper on the CPU."""

    weights = None

    def gradients_rowwise(self, score, label, weight):
        return score - label, torch.ones_like(score)
