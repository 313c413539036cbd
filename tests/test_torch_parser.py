"""The port's text parser (native/, data/reader.py, io/parser.py) against
the JAX package's on the same files.

Every case runs twice: with the native library (the reference's Atof)
and with ``LIGHTGBM_TPU_NO_NATIVE`` (pandas' C engine), each package on
the same backend.  The arrays must be bit-equal, NaN where NaN: features,
label, weights, query sizes, feature names and the label's index.
``atof`` is held bit for bit on tokens where the reference's Atof and a
correctly rounded parse differ.
"""

import numpy as np
import pytest

import lightgbm_tpu.native as jnative
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.reader import DenseChunkReader as JDenseReader
from lightgbm_tpu.io.parser import load_text_file as jload
from lightgbm_tpu.io.parser import sniff_format as jsniff
from lightgbm_tpu.utils.log import LightGBMError as JError

import lightgbm_tpu_torch.native as tnative
from lightgbm_tpu_torch import LightGBMError
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.data import reader as treader
from lightgbm_tpu_torch.io.parser import load_text_file, sniff_format


@pytest.fixture(params=["native", "pandas"])
def backend(request, monkeypatch):
    """Both packages on the native library, or both on pandas' C engine
    (the library switched off as a user would, and unloaded)."""
    if request.param == "pandas":
        monkeypatch.setenv("LIGHTGBM_TPU_NO_NATIVE", "1")
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    else:
        if tnative.get_lib() is None or jnative.get_lib() is None:
            pytest.skip("no C++ compiler for the native parser")
    return request.param


def bit_equal(a, b):
    """Same dtype and shape, NaN at the same places, every other value
    with the same bits."""
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.kind != "f":
        return np.array_equal(a, b)
    na, nb = np.isnan(a), np.isnan(b)
    return np.array_equal(na, nb) and a[~na].tobytes() == b[~nb].tobytes()


def assert_same_load(path, params):
    port = load_text_file(str(path), Config.from_params(dict(params)))
    jax = jload(str(path), JConfig.from_params(dict(params)))
    for name, x, y in zip(("features", "label", "weights", "group"), port[:4], jax[:4]):
        assert bit_equal(x, y), name
    assert port[4] == jax[4] and port[5] == jax[5]
    return port


# (file name, content, side files, params)
CASES = {
    "csv": ("d.csv", "1,1.413,2.5\n0,-7,1e-3\n1,0.30000000000000004,123456789.123456789\n",
            {}, {}),
    "tsv": ("d.tsv", "1\t2\t3\n0\t4.25\t-0.5\n", {}, {}),
    "whitespace": ("d.txt", "1 2   3\n0  4.5 6\n1\t7 8\n", {}, {}),
    "libsvm": ("d.svm", "1 0:1.413 3:2.5\n0 1:-7\n2 2:1e-3 3:4\n", {}, {}),
    "header": ("d.csv", "y,a,b\n0,1.5,2.5\n1,3.5,4\n", {}, {"header": "true"}),
    "label_index": ("d.csv", "5,6,0,7\n8,9,1,10\n", {}, {"label_column": "2"}),
    "label_name": ("d.csv", "a,b,y\n5,6,0\n8,9,1\n", {},
                   {"header": "true", "label_column": "name:y"}),
    # label column 1: weight 1 -> column 2, group 2 -> column 3 and
    # ignore 0 -> column 0 (indices past the label do not count it)
    "roles_index": ("d.csv", "9,1,0.5,7,1.5,2.5\n9,0,2,7,3.5,4.5\n9,1,1,8,5.5,6.5\n", {},
                    {"label_column": "1", "weight_column": "1", "group_column": "2",
                     "ignore_column": "0"}),
    "roles_name": ("d.csv", "x,y,w,q,a,b\n9,1,0.5,7,1.5,2.5\n9,0,2,7,3.5,4.5\n9,1,1,8,5.5,6.5\n",
                   {}, {"header": "true", "label_column": "name:y", "weight_column": "name:w",
                        "group_column": "name:q", "ignore_column": "name:x"}),
    "side_files": ("d.csv", "1,2,3\n0,4,5\n1,6,7\n0,8,9\n",
                   {".weight": "0.5\n1\n2\n0.25\n", ".query": "3\n1\n"}, {}),
    "libsvm_side_files": ("d.svm", "1 0:1 2:2\n0 1:3\n1 0:4\n",
                          {".weight": "1\n2\n3\n", ".query": "2\n1\n"}, {}),
    "empty_and_nan": ("d.csv", "1,,3\n4,na,\n0,nan,NaN\n1,inf,-inf\n", {}, {}),
    "blank_lines": ("d.tsv", "1\t2\t3\n\n4\t5\t6\n   \n\n7\t8\t9\n", {}, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_load_text_file_matches_jax(case, backend, tmp_path):
    name, text, side, params = CASES[case]
    path = tmp_path / name
    path.write_text(text)
    for suffix, body in side.items():
        (tmp_path / (name + suffix)).write_text(body)
    assert sniff_format(str(path)) == jsniff(str(path))
    feats = assert_same_load(path, params)[0]
    assert feats.shape[0] >= 2


def test_chunk_boundaries_match_jax(backend, tmp_path):
    """A file read in chunks of 7 rows gives the single-chunk rows, and
    the JAX package's chunks."""
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(100, 5)).round(5)
    lines = [",".join(f"{v:.5f}" for v in row) for row in vals]
    lines.insert(40, "")  # a blank line inside a chunk
    path = tmp_path / "c.csv"
    path.write_text("\n".join(lines) + "\n")
    port = list(treader.DenseChunkReader(str(path), ",", False, chunk_rows=7).iter_chunks())
    jax = list(JDenseReader(str(path), ",", False, chunk_rows=7).iter_chunks())
    assert [s for s, _ in port] == [s for s, _ in jax] == list(range(0, 100, 7))
    for (_, a), (_, b) in zip(port, jax):
        assert bit_equal(a, b)
    whole, _ = treader.DenseChunkReader(str(path), ",", False).read_all()
    assert bit_equal(np.vstack([c for _, c in port]), whole)
    assert treader.count_data_lines(str(path)) == 100


@pytest.mark.parametrize("name,text", [
    ("d.csv", "1,2,3\n0,abc,5\n1,6,7\n0,8\n1,9,10\n"),
    ("d.svm", "1 0:1 2:2\n0 1:x\n1 0:4\n"),
])
def test_bad_row_policy_matches_jax(name, text, backend, tmp_path):
    path = tmp_path / name
    path.write_text(text)
    with pytest.raises(LightGBMError, match="malformed data row 2"):
        load_text_file(str(path), Config())
    with pytest.raises(JError, match="malformed data row 2"):
        jload(str(path), JConfig())
    port = assert_same_load(path, {"bad_row_policy": "skip"})
    assert port[0].shape[0] == (3 if name.endswith(".csv") else 2)


ATOF_TOKENS = ["1.413", "0.1", "0.30000000000000004", "123456789.123456789", "-2.5E+2", "1e-3",
               "+3.5", ".5", "5.", "  7", "1e308", "1e400", "4.9e-324", "2.2250738585072014e-308",
               "na", "NaN", "inf", "-Infinity", "", "1e", "0.000001", "9007199254740993"]


def test_atof_bit_for_bit():
    if tnative.get_lib() is None or jnative.get_lib() is None:
        pytest.skip("no C++ compiler for the native parser")
    port = np.asarray([tnative.atof(t) for t in ATOF_TOKENS])
    jax = np.asarray([jnative.atof(t) for t in ATOF_TOKENS])
    assert port.tobytes() == jax.tobytes()
    assert tnative.atof("1.413") == 1.4129999999999998 != float("1.413")


def test_native_library_builds_under_build(tmp_path, monkeypatch):
    """The library builds into the directory LIGHTGBM_TPU_NATIVE_CACHE
    names (by default build/native/), keyed by the source's hash."""
    monkeypatch.setenv("LIGHTGBM_TPU_NATIVE_CACHE", str(tmp_path))
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    lib = tnative.get_lib()
    if lib is None:
        pytest.skip("no C++ compiler for the native parser")
    assert tnative.library_path().startswith(str(tmp_path))
    assert [p.name for p in tmp_path.iterdir()] == [tnative.library_path().split("/")[-1]]
    monkeypatch.delenv("LIGHTGBM_TPU_NATIVE_CACHE")
    assert "/build/native/parser_" in tnative.library_path()


def test_parser_use_is_counted(backend, tmp_path):
    path = tmp_path / "d.csv"
    path.write_text("1,2\n0,3\n")
    before = treader.parser_blocks().get(backend, 0)
    load_text_file(str(path), Config())
    assert treader.parser_blocks()[backend] == before + 1
