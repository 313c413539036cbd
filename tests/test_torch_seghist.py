"""The mask grower's histograms, B8 ``hist_segment`` and B9
``hist_segment_q`` (lightgbm_tpu_torch/ops/histogram.py), on edge cases.

- The plain versions, which the CPU runs, against the JAX package's
  Pallas kernels in interpret mode on the same seeded packed matrices:
  no row selected, one row, every row, every row in one bin, range ends
  that are not multiples of 4, and 600 features (which the card's float64
  cells take in feature tiles), with 8- and 16-bit bin words.  B9 is
  exact; B8's counts exact and its sums within 2e-3 of the largest bin
  (interpret mode emulates the TPU's bf16 three-term sums, the port sums
  in float64 and rounds once; the tolerance of
  tests/test_torch_maskgrow.py).
- The pure-Python sizing of the kernels' cached workspace
  (``workspace_size``), and that the CPU path neither builds one nor
  counts selected rows.

The kernels themselves are held against these plain versions on the card
by tests/test_torch_cuda.py (``cuda`` marker) and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import histogram_pallas as jhp
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import pkernels as pk

HIST_TOL = 2e-3
N = 2048  # a multiple of the Pallas kernels' 1024-column block

# name: (features, bins for 8-bit words, selected mask kind, lo, hi, one bin)
CASES = {
    "no-row": (7, 32, "none", 0, N, False),
    "one-row": (7, 32, "one", 0, N, False),
    "every-row": (7, 32, "all", 0, N, False),
    "one-bin": (7, 32, "all", 0, N, True),
    "unaligned-ends": (7, 32, "some", 3, N - 5, False),
    "600-features": (600, 16, "some", 1, N - 2, False),
}


def _inputs(case, bits, quantized):
    """(JAX packed matrix, port packed matrix, F, B, lo, hi) of a case."""
    f, b, kind, lo, hi, one_bin = CASES[case]
    if bits == 16:
        b = 300
    rng = np.random.default_rng(sum(map(ord, case)) + bits)
    bins = rng.integers(0, b, (N, f))
    if one_bin:
        bins[:] = b // 2
    bins = bins.astype(np.uint8 if bits == 8 else np.uint16)
    sel = {"none": np.zeros(N), "all": np.ones(N), "some": rng.random(N) < 0.4,
           "one": np.arange(N) == N // 3}[kind].astype(np.float32)
    if quantized:
        g = rng.integers(-15, 16, N).astype(np.int16)
        h = rng.integers(0, 16, N).astype(np.int16)
        jpack, tpack = jhp.pack_columns_q, th.pack_columns_q
    else:
        g = rng.standard_normal(N).astype(np.float32)
        h = np.abs(rng.standard_normal(N)).astype(np.float32)
        jpack, tpack = jhp.pack_columns, th.pack_columns
    per = 32 // bits
    pj = jpack(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h), jnp.asarray(sel), per=per,
               bits=bits)
    tb = torch.from_numpy(bins if bits == 8 else bins.astype(np.int32))
    pt = tpack(tb, torch.from_numpy(g), torch.from_numpy(h), torch.from_numpy(sel), per, bits)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    return pj, pt, f, b, lo, hi


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("quantized", [False, True], ids=["hist_segment", "hist_segment_q"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_versions_match_pallas_on_edges(case, quantized, bits):
    pj, pt, f, b, lo, hi = _inputs(case, bits, quantized)
    per = 32 // bits
    jfn = jhp.hist_segment_q if quantized else jhp.hist_segment
    want = np.asarray(jfn(pj, jnp.int32(lo), jnp.int32(hi), f, b, per=per, bits=bits,
                          interpret=True))
    fn = th.hist_segment_q if quantized else th.hist_segment
    got = fn(pt, lo, hi, f, b, per, bits).numpy()  # the CPU runs the plain version
    assert got.dtype == (np.int32 if quantized else np.float32)
    if quantized:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got[..., 2], want[..., 2])
        err = np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1.0)
        assert err < HIST_TOL
    sel = pt[-1, lo:hi]
    assert int(got[..., 2].sum()) == f * int((sel != 0).sum())  # every selected row, every feature


@pytest.mark.parametrize("rows,cells", [(0, 1), (1, 1), (th.WORK_STEP - 2, 10), (10_500_000, 9072),
                                        (464_809, 54 * 63 * 3)])
def test_workspace_size_covers_the_call(rows, cells):
    words, ncells = th.workspace_size(rows, cells)
    assert words >= 2 + rows and ncells >= cells  # the two counters, the list, the cells
    assert words % th.WORK_STEP == 0 and ncells % th.WORK_STEP == 0
    assert words - (2 + rows) < th.WORK_STEP and ncells - cells < th.WORK_STEP


def test_workspace_size_never_shrinks():
    big = th.workspace_size(10_500_000, 600 * 64 * 3)
    assert th.workspace_size(1000, 10, big) == big
    words, ncells = th.workspace_size(20_000_000, 10, big)
    assert words > big[0] and ncells == big[1]


def test_cpu_path_counts_no_kernel_rows():
    """The plain versions on the CPU launch nothing: no workspace, no
    launches, no selected-row tally."""
    pk.reset_launch_counts()
    had = list(th._WORK)
    _, pt, f, b, lo, hi = _inputs("unaligned-ends", 8, False)
    th.hist_segment(pt, lo, hi, f, b)
    counts = pk.launch_counts()
    assert counts["hist_segment"] == 0 and counts["hist_segment_rows"] == 0
    assert counts["hist_segment_q_rows"] == 0
    assert list(th._WORK) == had  # no workspace made
    if not torch.cuda.is_available():
        assert not th._WORK
