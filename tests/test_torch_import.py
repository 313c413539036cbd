"""lightgbm_tpu_torch stands alone: it imports torch and numpy, never jax
or the JAX package, builds its kernels lazily, and its entry points
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


def test_import_pulls_in_no_jax():
    code = ("import sys, lightgbm_tpu_torch, lightgbm_tpu_torch.engine, "
            "lightgbm_tpu_torch.convert, lightgbm_tpu_torch.ops.pkernels; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'lightgbm_tpu' or m.startswith('lightgbm_tpu.')]; "
            "assert not bad, bad; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


IMPORT_RE = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|lightgbm_tpu)(?:[\s.]|$)", re.M)


@pytest.mark.parametrize("path", sorted(p.relative_to(REPO).as_posix()
                                        for p in PKG.rglob("*.py")))
def test_no_file_imports_jax(path):
    src = (REPO / path).read_text()
    assert not IMPORT_RE.search(src), f"{path} imports jax or lightgbm_tpu"


def test_kernel_sources_present():
    names = {p.name for p in (PKG / "csrc").glob("*.cu")}
    assert {"update_hist.cu", "partition_hist.cu", "score_add.cu"} <= names


def test_train_without_device_raises_when_no_card(monkeypatch):
    import lightgbm_tpu_torch as lgt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).standard_normal((200, 3))
    y = (X[:, 0] > 0).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lgt.train({"objective": "binary"}, lgt.Dataset(X, label=y), 1)


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
    assert pk.launch_counts() == {"update_and_root_hist": 0, "level_stream": 0,
                                  "split_stream": 0, "score_add": 0}
    assert float(pk.f32_row(p, lay.SCORE, 100).sum()) == 100.0
