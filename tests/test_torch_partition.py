"""The launch geometry and argument checks of the partition kernels
(lightgbm_tpu_torch/ops/pkernels.py level_stream / split_stream), which
are plain Python and run here; the kernels themselves run only on the
card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import pkernels as pk

SMS = 132  # an H100 SXM


@pytest.mark.parametrize("cnt", [0, 1, 7, 41_000, 10_500_000])
def test_tile_covers_each_row_once(cnt):
    tile = pk.partition_tile(cnt, SMS)
    assert tile % pk.PART_CHUNK == 0
    assert pk.PART_CHUNK <= tile <= pk.PART_MAX_TILE
    blocks = int(pk.partition_blocks([cnt], tile)[0])
    assert blocks == -(-cnt // tile)
    # tile t covers [t*tile, min((t+1)*tile, cnt)): every row once, and no
    # block starts past the segment
    cover = np.zeros(cnt, np.int64)
    for t in range(blocks):
        lo, hi = t * tile, min((t + 1) * tile, cnt)
        assert lo < hi
        cover[lo:hi] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("cnt,blocks", [(41_000, 81), (10_500_000, 132)])
def test_grid_follows_the_segment(cnt, blocks):
    """A 41k-row tail leaf spreads over tens of blocks; all 10.5M rows over
    one block an SM."""
    assert int(pk.partition_blocks([cnt], pk.partition_tile(cnt, SMS))[0]) == blocks


def test_tile_caps():
    assert pk.partition_tile(10 ** 9, SMS) == pk.PART_MAX_TILE
    assert pk.partition_tile(10 ** 6, 10 ** 6) == pk.PART_CHUNK


def test_blocks_of_a_table():
    cnts = [0, 1, pk.PART_CHUNK, pk.PART_CHUNK + 1, -5]
    assert pk.partition_blocks(cnts, pk.PART_CHUNK).tolist() == [0, 1, 1, 2, 0]


def _matrix(n=100, f=5):
    lay = pk.PLayout(f)
    return pk.pack_matrix(np.zeros((n, f), np.uint8), lay), lay


@pytest.mark.parametrize("kw,match", [
    (dict(start=-1), "outside the matrix's 100 rows"),
    (dict(cnt=-1), "outside the matrix's 100 rows"),
    (dict(start=60, cnt=41), "outside the matrix's 100 rows"),
    (dict(word=16), "predicate field"),
    (dict(word=-1), "predicate field"),
    (dict(shift=4), "predicate field"),
    (dict(shift=32), "predicate field"),
    (dict(bits=16), "4 or 8"),
    (dict(num_features=200), "features or channel rows"),
    (dict(rows=(8, 9, 16)), "features or channel rows"),
])
def test_split_args_rejected(kw, match):
    p, lay = _matrix()
    args = dict(start=10, cnt=20, word=1, shift=8, bits=8, num_features=lay.F, rows=lay.rows)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        pk.check_split_args(p, **args)


@pytest.mark.parametrize("start,cnt", [(0, 0), (0, 100), (99, 1), (100, 0)])
def test_split_args_accepted(start, cnt):
    p, lay = _matrix()
    pk.check_split_args(p, start, cnt, 1, 24, 8, lay.F, lay.rows)
    pk.check_split_args(p, start, cnt, 0, 28, 4, lay.F, lay.rows)


def test_split_args_of_a_table():
    """level_stream checks its whole segment table: one bad row of many
    raises; a negative count is an empty segment."""
    p, lay = _matrix()
    tab = np.asarray([[0, 40, 0, 0], [40, 30, 1, 8], [70, 30, 1, 16], [99, -3, 0, 8]])
    pk.check_table_args(p, tab, 8, lay.F, lay.rows)
    with pytest.raises(ValueError, match="outside the matrix's 100 rows"):
        pk.check_table_args(p, tab + np.asarray([0, 1, 0, 0]), 8, lay.F, lay.rows)
    with pytest.raises(ValueError, match="predicate field"):
        pk.check_table_args(p, tab + np.asarray([0, 0, 0, 4]), 8, lay.F, lay.rows)


def test_split_stream_counts_rows_on_card_only():
    """The wrappers count launches and split_stream's rows where a kernel
    runs; on the CPU the plain version runs and nothing is counted."""
    p, lay = _matrix()
    pk.reset_launch_counts()
    pk.split_stream(p, 10, 50, 0, 0, 0, 0, 3, 0, num_features=lay.F, num_bins=4)
    counts = pk.launch_counts()
    assert counts["split_stream"] == 0 and counts["split_stream_rows"] == 0
    pk.split_stream.launches, pk.split_stream.rows = 2, 41_000
    assert pk.launch_counts()["split_stream_rows"] == 41_000
    pk.reset_launch_counts()
    assert pk.launch_counts()["split_stream_rows"] == 0 == pk.split_stream.launches


@pytest.mark.parametrize("kernel", ["score_add", "split_stream"])
def test_wrapper_rejects_a_tensor_off_the_card(kernel):
    """Only a CPU tensor takes the plain version; any other device that is
    not the card raises before a launch."""
    p, lay = _matrix()
    meta = torch.empty(p.shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        if kernel == "score_add":
            pk.score_add(meta, lay, np.ones(100, np.float32), num_rows=100)
        else:
            pk.split_stream(meta, 10, 50, 0, 0, 0, 0, 3, 0, num_features=lay.F, num_bins=4)


def test_work_buffer_addresses_match_its_views():
    """The addresses handed to the partition kernels are those of the
    stream workspace's parts: the look-back words after the ticket (both
    zero, as the kernels leave them), the plan after the clamped (n_seg,
    12) table, the float64 cells and a scratch of the matrix's size."""
    from lightgbm_tpu_torch.ops.histogram import _Workspace

    grid, n_seg, cells = 5, 3, 3 * 2 * 28 * 64 * 3
    w = _Workspace("cpu")
    w.fit(0, cells, scratch=16 * 1124, flags=grid + 1, plan=13 * n_seg + 3)
    flags, ticket, seg, plan = pk.partition_work(w, grid, n_seg)
    assert ticket == w.flags.data_ptr() and flags == ticket + 8
    assert seg == w.plan.data_ptr() and plan == seg + 4 * 12 * n_seg
    assert w.flags.numel() >= grid + 1 and w.plan.numel() >= 13 * n_seg + 3
    assert w.cells.numel() >= cells and w.scratch.numel() >= 16 * 1124
    assert int(w.flags.abs().sum()) == 0 and int(w.cells.abs().sum()) == 0


@pytest.mark.parametrize("seed", range(4))
def test_table_grid_bounds_the_tiles(seed):
    """The segment-table form launches partition_grid's static grid: the
    tiles of any disjoint active segments (at partition_tile of their
    rows, as the plan kernel takes it) fit in it, and that tile is at most
    the largest tile, which sizes shared memory."""
    rng = np.random.default_rng(seed)
    rows = int(rng.integers(1, 3_000_000))
    for n_seg in (1, 7, 128, 512):
        tile_max, grid = pk.partition_grid(rows, SMS, n_seg)
        cuts = np.sort(rng.integers(0, rows + 1, size=2 * n_seg))
        cnts = cuts[1::2] - cuts[0::2]  # disjoint segments, some empty
        n_act = int(rng.integers(0, n_seg + 1))
        cnts[n_act:] = 0
        tile = pk.partition_tile(int(cnts.sum()), SMS)
        assert tile <= tile_max <= pk.PART_MAX_TILE
        assert int(pk.partition_blocks(cnts, tile).sum()) <= grid
    assert pk.partition_grid(10_500_000, SMS, 128) == (79_872, 260)
    assert pk.partition_grid(10 ** 9, SMS, 1) == (pk.PART_MAX_TILE, 7631)
