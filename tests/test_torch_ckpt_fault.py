"""Kill and resume of the port's command line (``python -m
lightgbm_tpu_torch task=train``), as a preemptible machine runs it.

A training process (device=cpu, bagging and feature_fraction, a
checkpoint every 4 iterations) is killed once its first checkpoint is
durable: by SIGTERM, after which it flushes a checkpoint at the next
chunk's end, logs "preempted", exits 0 and writes no model; or by
SIGKILL.  The same command then resumes from the latest valid checkpoint,
and its model file is byte-identical to an uninterrupted run's.
"""

import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
ARGS = ["task=train", "objective=binary", "num_leaves=7", "learning_rate=0.2",
        "min_data_in_leaf=20", "num_trees=24", "snapshot_freq=4", "device=cpu",
        "bagging_fraction=0.7", "bagging_freq=2", "feature_fraction=0.8"]


@pytest.fixture(scope="module")
def data_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("faultdata") / "fault.train"
    rng = np.random.RandomState(0)
    X = rng.randn(2500, 10)
    y = (X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.1 * rng.randn(2500) > 0).astype(int)
    np.savetxt(path, np.column_stack([y, X]), fmt="%.10g", delimiter="\t")
    return str(path)


def _cmd(data_file, workdir):
    return [sys.executable, "-m", "lightgbm_tpu_torch", f"data={data_file}",
            f"output_model={workdir / 'model.txt'}", *ARGS]


def _run(cmd, workdir):
    r = subprocess.run(cmd, cwd=workdir, env=ENV, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


@pytest.fixture(scope="module")
def reference(data_file, tmp_path_factory):
    wd = tmp_path_factory.mktemp("ref")
    _run(_cmd(data_file, wd), wd)
    return (wd / "model.txt").read_bytes()


def _wait_for_checkpoint(workdir, proc, timeout=240):
    """Poll the manifest until a checkpoint is durable (an entry exists
    only after the fsync'd rename); False when the process ended first."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc.poll() is not None:
            return False
        try:
            if json.loads((workdir / "MANIFEST.json").read_text()).get("entries"):
                return True
        except (OSError, ValueError):
            pass
        time.sleep(0.01)
    raise TimeoutError("no checkpoint appeared")


@pytest.mark.faultinject
@pytest.mark.parametrize("sig", [signal.SIGKILL, signal.SIGTERM], ids=["sigkill", "sigterm"])
def test_kill_resume_bit_identical(data_file, reference, tmp_path, sig):
    cmd = _cmd(data_file, tmp_path)
    child = subprocess.Popen(cmd, cwd=tmp_path, env=ENV, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
    try:
        armed = _wait_for_checkpoint(tmp_path, child)
    except BaseException:
        child.kill()
        child.communicate()
        raise
    if not armed:
        out, _ = child.communicate()
        pytest.fail("training finished before the kill landed:\n" + out[-2000:])
    child.send_signal(sig)
    out, _ = child.communicate(timeout=240)
    if sig == signal.SIGTERM:
        assert child.returncode == 0, out[-2000:]
        assert "preempted" in out.lower(), out[-2000:]
    else:
        assert child.returncode == -signal.SIGKILL
    assert not (tmp_path / "model.txt").exists(), "the killed run must not finish"

    out = _run(cmd, tmp_path)
    assert "Resuming training from checkpoint" in out, out[-2000:]
    model = (tmp_path / "model.txt").read_bytes()
    assert hashlib.sha256(model).hexdigest() == hashlib.sha256(reference).hexdigest()
