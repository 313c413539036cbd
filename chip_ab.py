#!/usr/bin/env python3
"""Time one checkout of lightgbm_tpu_torch on one NVIDIA card, to compare
two commits inside one call:

    git archive HEAD | tar -x -C build/parent      # the parent commit
    for t in build/parent . . build/parent; do python3 chip_ab.py $t; done

TREE is the root of a checkout: its lightgbm_tpu_torch and chip_smoke.py
are the ones imported, and its kernels are built into its own build/.
Compare only numbers taken in one call (the card's clocks and power
limit differ between calls).  Prints one line starting with "AB" per
measurement:

- s/iter (median after the first iteration) of ``lgt.train`` on 3M
  Higgs-shaped rows, the higgs cell's parameters, at max_bin=63 (12
  iterations) and max_bin=255 (6 iterations);
- milliseconds a launch (median of 5 bursts of 10 launches, each burst
  between two CUDA events) of update_and_root_hist, level_stream (one
  segment of all rows), split_stream (all rows, a 41,000-row segment and
  a 139,291-row one, see TAIL_ROWS) at 10.5M x 28 features, 64 and 256
  bins, and of score_add and Tensor.add_ on the same score row; the
  single-call time (one launch between the events, so with the host's
  time to make the call) beside split_stream and score_add;
- the mask grower's histograms at their paths' shapes (see HIST_CELLS):
  hist_segment (B8) on the covertype-581k-goss cell's 464,809 training
  rows x 54 features, hist_segment_q (B9) on 10.5M x 28 quantized rows
  of 64 bins, each with that cell's mean selected rows per launch
  scattered at random, in bursts, single and by kernel on the device
  (torch.profiler); and their fixed cost: the
  same launch with no row selected, over all features and over one.

``--hist`` times only the mask grower's histograms (the last item above).
``--upd`` times only the update kernels: update_and_root_hist (B1) at
10.5M x 28 with a delta (64 and 256 bins) and with a select and GOSS
multiplier, update_multi_and_hists (B2) on the covertype cell's bundled
matrix (softmax and one-vs-all) and at K=16 (feature tiles), in bursts,
single and by kernel on the device, and B1's device time by part (no
histogram, one feature, every row in one bin).
``--part`` times only the partition kernels (level_stream, split_stream) at
64 bins, as the kernels item above, with split_stream's device time a
call by kernel (torch.profiler), and, where the tree's wrappers take
their segments as device tensors, those launches beside (the form the
fused grower runs, whose device time is what a graph replay costs), and
an empty one (a count of 0).
``--e2e`` times the higgs-10.5M cell (10.5M Higgs-shaped rows, the higgs
cell's parameters) and the covertype-581k cell (chip_smoke.py's data and
parameters) end to end: after one iteration (a tree's CUDA graph capture,
where the tree has one), s/iter as the host clock's seconds over one
chunk of E2E_ITERS iterations ending in a synchronize; the host syncs of
a 2-iteration chunk (torch.cuda.set_sync_debug_mode("warn")); and a
2-iteration torch.profiler window: wall, device busy ms and idle share.
``--cells`` times instead one cell against another inside one process:
it trains one binned dataset (10.5M Higgs-shaped rows, the higgs cell's
parameters, 16 iterations per run) in the order

    plain, goss, bagging, [profiler window], plain, bagging, goss, plain

and prints one line starting with "CELL" per run: its place, its s/iter
(median after the first iteration), the host CPU time, the load average
and the card's SM clock, power and temperature after it, and, for GOSS,
the medians of its warm-up and sampled iterations beside the plain runs'
medians over the same iterations.  The profiler window is chip_smoke.py's
``profile_iters`` over one iteration of the plain cell.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

TRAIN_ROWS, KERNEL_ROWS = 3_000_000, 10_500_000
# split_stream's segment sizes: 41,000 rows is 10.5M rows over the level
# grower's 256 leaves, an estimate; 139,291 is the mean segment that the
# higgs-10.5M cell's split_stream launches took on the card
# (chip_smoke.py, split_stream's rows over its launches)
TAIL_ROWS = (41_000, 139_291)
ITERS = {63: 12, 255: 6}  # max_bin: iterations
# the mask grower's histogram cells: (kernel, rows, features, selected
# rows per launch: the cell's mean, from chip_smoke.py's tally on the
# card); B8's bins are the covertype cell's, B9's 64 random bins
HIST_CELLS = (("hist_segment", 464_809, 54, 3_544), ("hist_segment_q", 10_500_000, 28, 158_830))
CELL_ROWS, CELL_ITERS = 10_500_000, 16
E2E_ITERS = {"higgs-10.5M": 8, "covertype-581k": 4}
CELL_ORDER = ("plain", "goss", "bagging", "profile", "plain", "bagging", "goss", "plain")


def gpu_state() -> str:
    """The card's SM clock, power draw and temperature now, from
    nvidia-smi."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "card state not read"
    return f"card {smi.stdout.strip()}"


def burst_ms(fn, bursts=5, burst=10):
    """Median milliseconds a launch over ``bursts`` bursts of ``burst``
    launches, each burst between one pair of CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(bursts):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(burst):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / burst)
    return float(np.median(times))


def hist_cells(tree, cs, lgt, dev):
    """Print the "AB" lines of each HIST_CELLS entry: the kernel at the
    cell's mean selected rows (bursts, single, device time by kernel);
    with no row selected, over all features and over one; the device
    time by kernel over other selected counts."""
    import torch

    from lightgbm_tpu_torch.ops import histogram as th

    rng = np.random.default_rng(3)
    for name, n, F, sel in HIST_CELLS:
        if name == "hist_segment":
            X, y = cs.make_covertype_shaped()
            ds = lgt.Dataset(X[:n], label=y[:n])
            bins = torch.from_numpy(ds.construct(cs.COV_PARAMS).binned).to(dev)
            B = int(ds.construct(cs.COV_PARAMS).max_num_bin)
            del X, y, ds
            g = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).to(dev)
            h = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
            pack, kern = th.pack_columns, th.hist_segment
        else:
            B = 64
            bins = torch.from_numpy(rng.integers(0, B, (n, F), dtype=np.uint8)).to(dev)
            g = torch.from_numpy(rng.integers(-15, 16, n).astype(np.int16)).to(dev)
            h = torch.from_numpy(rng.integers(1, 16, n).astype(np.int16)).to(dev)
            pack, kern = th.pack_columns_q, th.hist_segment_q
        P = pack(bins, g, h, torch.ones(n, device=dev))
        del bins, g, h
        W = P.shape[0] - 3
        one = P[W + 2, 0].item()  # float32 1.0 or int32 1
        order = torch.from_numpy(rng.permutation(n)).to(dev)

        def select(k):
            P[W + 2] = 0
            P[W + 2, order[:k]] = one

        def run(feats=F):
            kern(P, 0, n, feats, B, 4, 8, (W, W + 1, W + 2))

        select(0)
        none, none1 = burst_ms(run), burst_ms(lambda: run(1))
        sweep = {}
        for k in (0, 1, sel // 8, 8 * sel, n):
            select(k)
            sweep[k] = cs.device_split(run)
        select(sel)
        print(f"AB {tree} {name} rows {n} x {F} features, {B} bins, {sel} selected: "
              f"{burst_ms(run):.4f} ms (single {cs.time_cuda(run, 10):.4f}; device "
              f"{json.dumps(cs.device_split(run))}); no row selected {none:.4f} ms, over one "
              f"feature {none1:.4f} ms", flush=True)
        print(f"AB {tree} {name} device ms by selected rows: {json.dumps(sweep)}", flush=True)
        del P
        torch.cuda.empty_cache()


def upd_cells(tree, cs, lgt, dev):
    """Print the "AB" lines of the update kernels: update_and_root_hist
    (B1) at KERNEL_ROWS x 28 with a delta (64 and 256 bins) and with a
    select and GOSS multiplier (64 bins); update_multi_and_hists (B2) on
    the covertype cell's bundled training matrix (K=7, softmax and
    one-vs-all) and at K=16 x 28 x 64 (feature tiles); each in bursts,
    single and by kernel on the device.  Then B1's device time over a
    sweep that takes its parts apart: no histogram (with_hist=False),
    one feature against all, and every row in one bin against uniform
    bins."""
    import torch

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.ops import pkernels as pk

    def report(what, fn):
        dev_ms = cs.device_split(fn)
        print(f"AB {tree} {what}: {burst_ms(fn):.4f} ms (single {cs.time_cuda(fn, 10):.4f}; "
              f"device {sum(dev_ms.values()):.4f} {json.dumps(dev_ms)})", flush=True)

    F, n = 28, KERNEL_ROWS
    rng = np.random.default_rng(11)
    label = (rng.random(n) < 0.5).astype(np.float32)
    obj = cs._multi_objective("binary", 1, label)
    delta = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1).to(dev)
    sel = (torch.rand(n, device=dev) < 0.3).float()
    mul = torch.where(torch.rand(n, device=dev) < 0.5, 8.5, 1.0).float()
    lay = pk.PLayout(F)
    for B in (64, 256):
        P = pk.pack_matrix(rng.integers(0, B, size=(n, F), dtype=np.uint8), lay, label=label,
                           device=dev)
        kw = dict(num_rows=n, num_features=F, num_bins=B, bits=8)
        report(f"update_and_root_hist rows {n} x {F}, {B} bins, delta",
               lambda: pk.update_and_root_hist(P, lay, obj, delta=delta, **kw))
        if B == 64:
            report(f"update_and_root_hist rows {n} x {F}, {B} bins, sel 30 % + mul",
                   lambda: pk.update_and_root_hist(P, lay, obj, sel=sel, mul=mul, **kw))
            pk.f32_row(P, lay.SEL, n).fill_(1.0)  # every row selected again
            sweep = {}
            for what, f, w in (("all features", F, True), ("one feature", 1, True),
                               ("no histogram", F, False)):
                sweep[what] = cs.device_split(lambda: pk.update_and_root_hist(
                    P, lay, obj, delta=delta, **dict(kw, num_features=f), with_hist=w))
            P[: lay.W] = 0x05050505  # every row of every feature in bin 5
            sweep["every row in one bin"] = cs.device_split(
                lambda: pk.update_and_root_hist(P, lay, obj, delta=delta, **kw))
            print(f"AB {tree} update_and_root_hist device ms by part: {json.dumps(sweep)}",
                  flush=True)
        del P
        torch.cuda.empty_cache()

    X, y = cs.make_covertype_shaped()
    nc = cs.COV_TRAIN_ROWS
    ds = lgt.Dataset(X[:nc], label=y[:nc])
    ds.construct(cs.COV_PARAMS).ensure_bundles(Config.from_params(cs.COV_PARAMS))
    bds = ds.construct(cs.COV_PARAMS)
    K, mat = 7, bds.bundled
    rows, G = mat.shape
    BH = int(bds.bundle.max_col_bin)
    lay = pk.PLayout(G, num_score=K)
    P = pk.pack_matrix(mat, lay, label=bds.metadata.label, device=dev)
    for k in range(K):
        pk.f32_row(P, lay.SCORE + k, rows).copy_(torch.randn(rows, device=dev))
    for name in ("multiclass", "multiclassova"):
        mobj = cs._multi_objective(name, K, bds.metadata.label)
        report(f"update_multi_and_hists {name} rows {rows} x {G} columns, {BH} bins, K={K}",
               lambda: pk.update_multi_and_hists(P, lay, mobj, num_rows=rows, num_features=G,
                                                 num_bins=BH))
    del P, X, y, ds, bds
    Kw, nw = 16, 200_000
    lay = pk.PLayout(28, num_score=Kw)
    labw = rng.integers(0, Kw, nw).astype(np.float32)
    P = pk.pack_matrix(rng.integers(0, 64, size=(nw, 28), dtype=np.uint8), lay, label=labw,
                       device=dev)
    mobj = cs._multi_objective("multiclass", Kw, labw)
    report(f"update_multi_and_hists K={Kw} rows {nw} x 28, 64 bins (feature tiles)",
           lambda: pk.update_multi_and_hists(P, lay, mobj, num_rows=nw, num_features=28,
                                             num_bins=64))
    del P
    torch.cuda.empty_cache()


def _is_sync(w) -> bool:
    """A warning of sync debug mode "warn" for one synchronizing call (its
    first use in a process also warns that the mode is a prototype)."""
    text = str(w.message)
    return "synchroniz" in text and "debug mode" not in text


def count_syncs(fn) -> int:
    """Host syncs PyTorch reports while ``fn`` runs (sync debug mode
    "warn": one warning a synchronizing call)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum(_is_sync(w) for w in caught)


def e2e_cells(tree, cs, lgt, dev):
    """Print one "AB" line per cell of E2E_ITERS (see the module doc)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    X, y = cs.make_higgs_shaped(CELL_ROWS, seed=7)
    higgs = lgt.Dataset(X, label=y)
    higgs.construct(cs.TRAIN_PARAMS)
    del X
    X, y = cs.make_covertype_shaped()
    cov = lgt.Dataset(X[:cs.COV_TRAIN_ROWS], label=y[:cs.COV_TRAIN_ROWS])
    cov.construct(cs.COV_PARAMS)
    for name, params, ds, K in (("higgs-10.5M", cs.TRAIN_PARAMS, higgs, 1),
                                ("covertype-581k", cs.COV_PARAMS, cov, 7)):
        n = E2E_ITERS[name]
        bst = lgt.Booster(params, ds, device=dev)
        bst.boosting.train_iters(1)
        cs.sync(dev)
        t = time.perf_counter()
        bst.boosting.train_iters(n)
        cs.sync(dev)
        s_iter = (time.perf_counter() - t) / n
        syncs = count_syncs(lambda: (bst.boosting.train_iters(2), cs.sync(dev)))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            bst.boosting.train_iters(2)
            cs.sync(dev)
            wall = (time.perf_counter() - t) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        print(f"AB {tree} cell {name}: s/iter {s_iter:.4f} over {n} iterations (one chunk, host "
              f"clock); host syncs in a 2-iteration chunk {syncs} ({syncs / (2 * K):.1f} a tree); "
              f"profile of 2 iterations: wall {wall:.1f} ms, device busy {busy:.1f} ms "
              f"({busy / 2:.2f} ms an iteration), idle {100 - 100 * busy / wall:.1f}%; "
              f"{gpu_state()}", flush=True)
        del bst
        torch.cuda.empty_cache()


def run_cells(cs, lgt, dev):
    """Train each cell of CELL_ORDER on one dataset and print its CELL
    line; returns [(cell, iteration seconds), ...], the profiler window
    left out."""
    params = {"plain": cs.TRAIN_PARAMS, "bagging": cs.BAG_PARAMS, "goss": cs.GOSS_PARAMS}
    X, y = cs.make_higgs_shaped(CELL_ROWS, seed=7)
    ds = lgt.Dataset(X, label=y)
    ds.construct(cs.TRAIN_PARAMS)
    del X
    out = []
    for place, cell in enumerate(CELL_ORDER):
        if cell == "profile":
            cs.profile_iters(ds, dev, n_iter=1)
            continue
        cpu0 = time.process_time()
        bst = lgt.train(params[cell], ds, CELL_ITERS, device=dev, verbose_eval=False)
        cs.sync(dev)
        its = list(bst.boosting.ptrainer.iter_seconds)
        out.append((cell, its))
        print(f"CELL {place} {cell}: s/iter {np.median(its[1:]):.4f} (median after the "
              f"first); host CPU {time.process_time() - cpu0:.2f} s over {sum(its):.2f} s of "
              f"iterations; load average {os.getloadavg()[0]:.2f}; {gpu_state()}; "
              f"iterations {json.dumps([round(t, 4) for t in its])}", flush=True)
        del bst
    warm = int(1.0 / cs.GOSS_PARAMS["learning_rate"])
    plain = np.asarray([its for cell, its in out if cell == "plain"])
    for i, (cell, its) in enumerate(out):
        if cell == "goss":
            print(f"CELL goss run {i}: warm-up {np.median(its[1:warm]):.4f}, sampled "
                  f"{np.median(its[warm:]):.4f}; plain runs at the same iterations "
                  f"{np.median(plain[:, 1:warm]):.4f} and {np.median(plain[:, warm:]):.4f}",
                  flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree")
    ap.add_argument("--cells", action="store_true",
                    help="time the plain, bagging and GOSS cells in turns instead")
    ap.add_argument("--hist", action="store_true",
                    help="time only the mask grower's histograms (hist_segment, hist_segment_q)")
    ap.add_argument("--upd", action="store_true",
                    help="time only the update kernels (update_and_root_hist, "
                         "update_multi_and_hists)")
    ap.add_argument("--part", action="store_true",
                    help="time only the partition kernels (level_stream, split_stream)")
    ap.add_argument("--e2e", action="store_true",
                    help="time the higgs-10.5M and covertype-581k cells end to end")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import torch

    import chip_smoke as cs
    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.ops import pkernels as pk

    for mod in (cs, lgt):
        assert os.path.abspath(mod.__file__).startswith(tree + os.sep), mod.__file__
    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if args.cells:
        run_cells(cs, lgt, dev)
        return 0
    if args.hist:
        hist_cells(tree, cs, lgt, dev)
        return 0
    if args.upd:
        upd_cells(tree, cs, lgt, dev)
        return 0
    if args.e2e:
        e2e_cells(tree, cs, lgt, dev)
        return 0

    # ---- kernels at 64 and 256 bins
    F, n = 28, KERNEL_ROWS
    rng = np.random.default_rng(11)
    label = (rng.random(n) < 0.5).astype(np.float32)
    obj = create_objective(Config.from_params({"objective": "binary"}))
    md = Metadata(n)
    md.set_label(label)
    obj.init(md, n)
    delta = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1).to(dev)
    # the partition kernels given device tensors (the fused grower's form),
    # in a tree whose wrappers take them
    device_form = hasattr(pk, "partition_grid")
    for B in ((64,) if args.part else (64, 256)):
        lay = pk.PLayout(F)
        P = pk.pack_matrix(rng.integers(0, B, size=(n, F), dtype=np.uint8), lay, label=label,
                           device=dev)
        kw = dict(num_rows=n, num_features=F, num_bins=B, bits=8)
        upd = burst_ms(lambda: pk.update_and_root_hist(P, lay, obj, delta=delta, **kw))
        thr = B // 2 - 1
        tab = np.zeros((8, 12), np.int64)
        tab[0] = [0, n, 1, 16, 0, 0, thr, 0, 0, 256, 0, 0]
        lvl = burst_ms(lambda: pk.level_stream(P, torch.from_numpy(tab), 1, num_features=F,
                                               num_bins=B, bits=8, smax=8))
        line = (f"AB {tree} kernels rows {n} bins {B}: update_and_root_hist {upd:.4f} ms, "
                f"level_stream {lvl:.4f} ms")
        if device_form:
            dtab, one = torch.from_numpy(tab).to(dev), torch.tensor(1, device=dev)
            line += (", level_stream given a device table " + str(round(burst_ms(
                lambda: pk.level_stream(P, dtab, one, num_features=F, num_bins=B, bits=8,
                                        smax=8)), 4)) + " ms")
            zero = [torch.tensor(v, device=dev) for v in (0, 0, 1, 16, 0, 0, thr, 0)]
            line += (", split_stream given device scalars with a count of 0: device " + str(round(
                sum(cs.device_split(lambda: pk.split_stream(
                    P, *zero, num_features=F, num_bins=B, bits=8)).values()), 4)) + " ms")
        for cnt in (n, *TAIL_ROWS):
            seg = (n - cnt, cnt, 1, 16, 0, 0, thr, 0)

            def split(seg=seg):
                pk.split_stream(P, *seg, num_features=F, num_bins=B, bits=8)
            line += (f", split_stream {cnt} rows {burst_ms(split):.4f} ms (single "
                     f"{cs.time_cuda(split, 10):.4f})")
            line += f" device {sum(cs.device_split(split).values()):.4f} ms"
            if device_form:
                dseg = [torch.tensor(v, device=dev) for v in seg]
                line += (f"; given device scalars {burst_ms(lambda: split(dseg)):.4f} ms (single "
                         f"{cs.time_cuda(lambda: split(dseg), 10):.4f}, device "
                         f"{sum(cs.device_split(lambda: split(dseg)).values()):.4f})")
        if B == 64:
            srow = pk.f32_row(P, lay.SCORE, n)
            for what, fn in (("score_add", lambda: pk.score_add(P, lay, delta, num_rows=n)),
                             ("Tensor.add_", lambda: srow.add_(delta))):
                line += f", {what} {burst_ms(fn):.4f} ms (single {cs.time_cuda(fn, 20):.4f})"
        print(line + " (bursts of 10 launches; single: one launch between events)", flush=True)
        del P
        torch.cuda.empty_cache()
    if args.part:
        return 0

    hist_cells(tree, cs, lgt, dev)

    # ---- end to end
    X, y = cs.make_higgs_shaped(TRAIN_ROWS, seed=7)
    for max_bin, iters in ITERS.items():
        params = dict(cs.TRAIN_PARAMS, max_bin=max_bin)
        bst = lgt.train(params, lgt.Dataset(X, label=y), iters, device=dev)
        its = bst.boosting.ptrainer.iter_seconds
        print(f"AB {tree} rows {TRAIN_ROWS} max_bin {max_bin}: s/iter "
              f"{float(np.median(its[1:])):.4f} first {its[0]:.3f}", flush=True)
        del bst
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
