#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one NVIDIA Hopper card.

    python3 chip_smoke.py                 # the full run (one card)
    python3 chip_smoke.py --rows 1000000 --iters 3 --small-rows 20000

Phases (any failure raises, and the script exits non-zero without a
result line):
  1. device: needs torch.cuda; prints the card's name and power limit;
  2. build: compiles the CUDA kernels from lightgbm_tpu_torch/csrc;
  3. kernels: calls each kernel's wrapper at the main path's shapes
     (--rows x 28 features, 64 bins) and holds it against its plain
     PyTorch version on the same inputs; times both with CUDA events;
  4. small end to end: --small-rows x 28 trained on the card and on the
     CPU (plain versions) — splits, predictions and AUC must agree;
  5. the slice at full width: Higgs-shaped binary data (--rows plus a
     500k held-out set), max_bin=63, num_leaves=255, learning_rate=0.1,
     min_data_in_leaf=1, min_sum_hessian_in_leaf=100, --iters
     iterations; prints s/iter, held-out AUC, peak memory and the
     launch counts of every kernel, then a run with the level grower off
     (so split_stream carries every split) and a repeat of the main run
     to show whether two runs give byte-identical model text.
The line before last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
TRAIN_PARAMS = dict(objective="binary", max_bin=63, num_leaves=255, learning_rate=0.1,
                    min_data_in_leaf=1, min_sum_hessian_in_leaf=100, verbose=-1)
REPLACES = {
    "update_and_root_hist": "lightgbm_tpu/ops/pkernels.py:542",
    "level_stream": "lightgbm_tpu/ops/pkernels.py:1309",
    "split_stream": "lightgbm_tpu/ops/pkernels.py:1378",
    "score_add": "lightgbm_tpu/ops/pkernels.py:825",
}
SOURCES = {
    "update_and_root_hist": "lightgbm_tpu_torch/csrc/update_hist.cu",
    "level_stream": "lightgbm_tpu_torch/csrc/partition_hist.cu",
    "split_stream": "lightgbm_tpu_torch/csrc/partition_hist.cu",
    "score_add": "lightgbm_tpu_torch/csrc/score_add.cu",
}
_TASK_SEED = 20260730  # bench.py: the task's informative weights never vary
_N_INFORM = 8


def make_higgs_shaped(n_rows, n_features=28, seed=7):
    """bench.py make_higgs_shaped: a few informative features plus noise,
    mildly non-linear decision surface; ``seed`` draws the rows only."""
    w = np.random.RandomState(_TASK_SEED).randn(_N_INFORM)
    rng = np.random.RandomState(seed)
    X = rng.randn(n_rows, n_features).astype(np.float32)
    margin = X[:, :_N_INFORM] @ w + 0.5 * X[:, 0] * X[:, 1] - 0.3 * X[:, 2] ** 2
    prob = 1.0 / (1.0 + np.exp(-margin / margin.std()))
    y = (rng.rand(n_rows) < prob).astype(np.float32)
    return X, y


def auc(y, p):
    """Rank AUC with tied scores sharing their average rank."""
    y = np.asarray(y) > 0
    _, inv, cnt = np.unique(p, return_inverse=True, return_counts=True)
    first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    ranks = (first + (cnt + 1) / 2.0)[inv]
    npos = y.sum()
    nneg = y.size - npos
    return float((ranks[y].sum() - npos * (npos + 1) / 2.0) / (npos * nneg))


def log(*a):
    print(*a, flush=True)


def time_cuda(fn, reps, warmup=1):
    """Median milliseconds of ``fn`` over ``reps`` calls, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def rel_err(a, b):
    """max |a - b| over max(max |b|, 1): (relative, absolute)."""
    d = float((a.double() - b.double()).abs().max())
    return d / max(float(b.double().abs().max()), 1.0), d


HIST_TOL = 1e-5


def check_hist(name, hk, hr):
    """Kernel histogram against the plain version's.  Counts are integers
    below 2^24, exact in float32 in any order: bit-equal.  The g and h
    sums, each channel relative to its largest bin, within HIST_TOL: the
    plain version sums in float64 and rounds once, the kernel adds float32
    per-block partials with atomics in an order that varies per run."""
    import torch

    assert torch.equal(hk[..., 2], hr[..., 2]), f"{name}: histogram counts differ"
    (eg, ag), (eh, ah) = rel_err(hk[..., 0], hr[..., 0]), rel_err(hk[..., 1], hr[..., 1])
    log(f"  {name} hist: g rel err {eg:.3e}, h rel err {eh:.3e} (tol {HIST_TOL:g}); "
        f"counts bit-equal")
    assert eg <= HIST_TOL and eh <= HIST_TOL, f"{name}: histogram differs from plain"
    return max(ag, ah)


# ----------------------------------------------------------------------
def phase_kernels(rows, dev, seed=11):
    """Each kernel against its plain version on the card, at the main
    path's shapes.  Returns {name: {...measurements}}."""
    import torch

    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.objective import create_objective
    from lightgbm_tpu_torch.ops import pkernels as pk

    F, B = 28, 64
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(rows, F), dtype=np.uint8)
    label = (rng.random(rows) < 0.5).astype(np.float32)
    lay = pk.PLayout(F)
    P0 = pk.pack_matrix(bins, lay, label=label, device=dev)
    del bins
    obj = create_objective(Config.from_params({"objective": "binary"}))
    md = Metadata(rows)
    md.set_label(label)
    obj.init(md, rows)
    delta = torch.from_numpy(rng.standard_normal(rows).astype(np.float32) * 0.1).to(dev)
    out = {}
    C, W = lay.C, lay.W

    # ---- update_and_root_hist
    Pk, Pr = P0.clone(), P0.clone()
    kw = dict(num_rows=rows, num_features=F, num_bins=B, bits=8)
    _, hk = pk.update_and_root_hist(Pk, lay, obj, delta=delta, **kw)
    _, hr = pk.update_and_root_hist_ref(Pr, lay, obj, delta=delta, **kw)
    sync(dev)
    chan_err = 0.0
    for r in range(C):
        if r in (lay.G, lay.H):
            e, _ = rel_err(Pk[r, :rows].view(torch.float32), Pr[r, :rows].view(torch.float32))
            chan_err = max(chan_err, e)
        elif not torch.equal(Pk[r], Pr[r]):
            raise AssertionError(f"update_and_root_hist: channel {r} differs from plain")
    assert torch.equal(Pk[:, rows:], Pr[:, rows:]), "update_and_root_hist wrote the tail"
    log(f"kernel update_and_root_hist: grad/hess rel err {chan_err:.3e} (tol 1e-6)")
    assert chan_err <= 1e-6
    habs = check_hist("update_and_root_hist", hk, hr)
    ms = time_cuda(lambda: pk.update_and_root_hist(Pk, lay, obj, delta=delta, **kw), 10)
    plain = time_cuda(lambda: pk.update_and_root_hist_ref(Pr, lay, obj, delta=delta, **kw), 3)
    # reads W words + score, label, weight, delta; writes g, h, score
    nbytes = rows * 4 * (W + 4 + 3) + F * B * 3 * 4
    # the logloss gradient (~12 ops with its exp) and 3 adds per feature
    nops = rows * (12 + 3 * F)
    out["update_and_root_hist"] = dict(max_abs_err=habs, ms=ms, plain_ms=plain,
                                       bytes=nbytes, ops=nops, library_ms=None)
    P0 = Pk.clone()  # fresh g/h channels for the partition kernels
    del Pk, Pr

    # ---- level_stream: empty, tiny unaligned, block-aligned and large
    # segments, numerical / categorical / zero-bin remap / EFB remap
    q, T = rows // 16, pk.PART_TILE
    a = -(-4 * q // T) * T  # block-aligned start
    specs = [  # (start, cnt, feat, thr, zero_bin, dbz, cat, off_lo, off_hi, bias)
        (0, q, 3, 31, 0, 0, 0, 0, 256, 0),
        (q, 0, 5, 10, 0, 0, 0, 0, 256, 0),  # empty
        (q + 3, 7, 7, 15, 0, 0, 0, 0, 256, 0),  # tiny, unaligned
        (q + 10, a - q - 10, 0, 7, 5, 11, 0, 0, 256, 0),  # zero-bin remap
        (a, 3 * T, 2, 9, 0, 0, 0, 0, 256, 0),  # block-aligned
        (a + 3 * T, 2 * q, 10, 4, 0, 0, 1, 0, 256, 0),  # categorical
        (a + 3 * T + 2 * q, 4 * q - 1, 12, 20, 0, 3, 0, 3, 40, 1),  # EFB range remap
        (a + 3 * T + 6 * q, rows - (a + 3 * T + 6 * q), 27, 50, 0, 0, 0, 0, 256, 0),
    ]  # one column before the last segment belongs to no segment
    tab = np.asarray([[s, c, f // 4, (f % 4) * 8, zb, dbz, thr, cat, lo, hi, bias, 0]
                      for s, c, f, thr, zb, dbz, cat, lo, hi, bias in specs], np.int64)
    nseg, smax = len(specs), 16
    Pk, Pr = P0.clone(), P0.clone()
    lkw = dict(num_features=F, num_bins=B, bits=8, smax=smax)
    _, nlk, hk = pk.level_stream(Pk, torch.from_numpy(tab), nseg, **lkw)
    _, nlr, hr = pk.level_stream_ref(Pr, torch.from_numpy(tab), nseg, **lkw)
    sync(dev)
    assert torch.equal(nlk.cpu(), nlr.cpu()), "level_stream: left counts differ"
    # the partition is stable in both versions: rows, order and every
    # channel are bit-identical, and untouched columns stay so
    assert torch.equal(Pk, Pr), "level_stream: partitioned matrix differs from plain"
    log(f"kernel level_stream: nl {nlk[:nseg].tolist()}; matrix bit-identical")
    habs = check_hist("level_stream", hk, hr)
    ms = time_cuda(lambda: pk.level_stream(Pk, torch.from_numpy(tab), nseg, **lkw), 10)
    plain = time_cuda(lambda: pk.level_stream_ref(Pr, torch.from_numpy(tab), nseg, **lkw), 3)
    active = int(tab[:, 1].sum())
    # every active row's C channels read and written once; the predicate
    # (~6 ops) and 3 adds per feature for the histograms
    out["level_stream"] = dict(max_abs_err=habs, ms=ms, plain_ms=plain,
                               bytes=active * C * 4 * 2 + nseg * 2 * F * B * 3 * 4,
                               ops=active * (6 + 3 * F), library_ms=None)

    # ---- split_stream: the root segment of the main path (all rows)
    Pk, Pr = P0.clone(), P0.clone()
    skw = dict(num_features=F, num_bins=B, bits=8)
    args = (0, rows, 1, 16, 0, 0, 31, 0)
    _, nk, lk, rk = pk.split_stream(Pk, *args, **skw)
    _, nr, lr, rr = pk.split_stream_ref(Pr, *args, **skw)
    sync(dev)
    assert int(nk) == int(nr), "split_stream: left counts differ"
    assert torch.equal(Pk, Pr), "split_stream: partitioned matrix differs from plain"
    log(f"kernel split_stream: nl {int(nk)}; matrix bit-identical")
    al = check_hist("split_stream left", lk, lr)
    ar = check_hist("split_stream right", rk, rr)
    ms = time_cuda(lambda: pk.split_stream(Pk, *args, **skw), 10)
    plain = time_cuda(lambda: pk.split_stream_ref(Pr, *args, **skw), 3)
    out["split_stream"] = dict(max_abs_err=max(al, ar), ms=ms, plain_ms=plain,
                               bytes=rows * C * 4 * 2 + 2 * F * B * 3 * 4,
                               ops=rows * (6 + 3 * F), library_ms=None)

    # ---- score_add
    Pk, Pr = P0.clone(), P0.clone()
    pk.score_add(Pk, lay, delta, num_rows=rows)
    pk.score_add_ref(Pr, lay, delta, num_rows=rows)
    sync(dev)
    assert torch.equal(Pk, Pr), "score_add differs from plain"
    log("kernel score_add: bit-identical")
    ms = time_cuda(lambda: pk.score_add(Pk, lay, delta, num_rows=rows), 20)
    plain = time_cuda(lambda: pk.score_add_ref(Pr, lay, delta, num_rows=rows), 5)
    srow = pk.f32_row(Pr, lay.SCORE, rows)
    lib = time_cuda(lambda: srow.add_(delta), 20)
    out["score_add"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bytes=rows * 12,
                            ops=rows, library_ms=lib)
    del P0, Pk, Pr
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for v in out.values():
        t_bytes = v.pop("bytes") / PEAK_BYTES_PER_S * 1e3
        t_ops = v.pop("ops") / PEAK_F32_OPS_PER_S * 1e3
        v["bound_ms"] = max(t_bytes, t_ops)
        v["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def model_splits(text):
    """Per tree: (split_feature, threshold, split_gain) lists."""
    trees, cur = [], {}
    for line in text.splitlines():
        for key in ("split_feature", "threshold", "split_gain"):
            if line.startswith(key + "="):
                cur[key] = line.split("=", 1)[1].split()
        if line.startswith("shrinkage=") and cur:
            trees.append(cur)
            cur = {}
    return trees


def phase_small(rows, iters, dev):
    """The same training on the card and on the CPU (plain versions)."""
    import lightgbm_tpu_torch as lgt

    X, y = make_higgs_shaped(rows, seed=3)
    Xv, yv = make_higgs_shaped(50_000, seed=4)
    out = {}
    for name, d in (("cuda", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        bst = lgt.train(TRAIN_PARAMS, lgt.Dataset(X, label=y), iters, device=d)
        p = bst.predict(Xv)
        out[name] = (bst.model_to_string(), p, auc(yv, p))
        log(f"small {name}: {rows}x28, {iters} iterations, {time.perf_counter() - t0:.1f} s, "
            f"AUC {out[name][2]:.6f}")
    tc, tg = model_splits(out["cpu"][0]), model_splits(out["cuda"][0])
    ndiff, first = 0, None
    for ti, (a, b) in enumerate(zip(tc, tg)):
        for i, fa, fb, ta, tb in zip(range(10**9), a["split_feature"], b["split_feature"],
                                     a["threshold"], b["threshold"]):
            if (fa, ta) != (fb, tb):
                ndiff += 1
                if first is None:
                    first = (ti, i, float(a["split_gain"][i]), float(b["split_gain"][i]))
    dpred = float(np.abs(out["cuda"][1] - out["cpu"][1]).max())
    dauc = abs(out["cuda"][2] - out["cpu"][2])
    log(f"small cuda vs cpu: {ndiff} split differences, max |dpred| {dpred:.3e} (tol 1e-3), "
        f"|dAUC| {dauc:.3e} (tol 1e-3)")
    if first is not None:
        ti, i, ga, gb = first
        rel = abs(ga - gb) / max(abs(ga), 1e-12)
        log(f"first differing split: tree {ti} node {i}, gains {ga!r} vs {gb!r} "
            f"(rel {rel:.3e}; near-tie tol 1e-3)")
        assert rel <= 1e-3, "a split differs and is not a near-tie"
    assert dpred <= 1e-3 and dauc <= 1e-3


def profile_iters(ds, dev, n_iter=3, top=12):
    """Device busy share of steady training iterations, and the device
    time by kernel, from torch.profiler.  The first iteration runs before
    the window; the window ends in a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import lightgbm_tpu_torch as lgt

    bst = lgt.Booster(TRAIN_PARAMS, ds, device=dev)
    bst.boosting.train_iters_partitioned(1)
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        bst.boosting.train_iters_partitioned(n_iter)
        sync(dev)
        wall_us = (time.perf_counter() - t) * 1e6

    def dev_us(e):
        return e.self_device_time_total

    # device-side events only (kernels, copies, memsets): a host op's own
    # device total would count its kernels a second time
    evs = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                 key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in evs)
    if busy == 0:
        log("profile: the profiler recorded no device time; busy share not measured")
        return
    log(f"profile: {n_iter} iterations, wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), idle {100 - 100 * busy / wall_us:.1f}%")
    for e in evs[:top]:
        log(f"  {dev_us(e) / 1e3:9.2f} ms {e.count:7d} calls  {e.key[:90]}")
    del bst
    torch.cuda.empty_cache()


def phase_full(rows, iters, dev):
    """The slice's main path at full width.  Returns the launch counts of
    the main run."""
    import torch

    import lightgbm_tpu_torch as lgt
    from lightgbm_tpu_torch.ops import pkernels as pk

    t0 = time.perf_counter()
    X, y = make_higgs_shaped(rows + 500_000, seed=7)
    Xv, yv = X[rows:], y[rows:]
    X, y = X[:rows], y[:rows]
    ds = lgt.Dataset(X, label=y)
    ds.construct(TRAIN_PARAMS)
    log(f"full: data {rows}x28 + 500000 held out, binned in {time.perf_counter() - t0:.1f} s")

    def run(n_iter):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        bst = lgt.train(TRAIN_PARAMS, ds, n_iter, device=dev)
        sync(dev)
        return bst, time.perf_counter() - t

    pk.reset_launch_counts()
    bst, wall = run(iters)
    counts = pk.launch_counts()
    its = bst.boosting.ptrainer.iter_seconds
    s_iter = float(np.median(its[1:])) if len(its) > 1 else float(its[0])
    pred = bst.predict(Xv)
    a = auc(yv, pred)
    peak = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    log(f"full: {iters} iterations in {wall:.2f} s; s/iter {s_iter:.4f} (median after the "
        f"first; first {its[0]:.3f} s); held-out AUC {a:.6f}; peak device memory "
        f"{peak:.2f} GiB; launches {json.dumps(counts)}")
    assert np.all(np.isfinite(pred)) and pred.shape == (yv.shape[0],)
    assert 0.6 < a <= 1.0, "held-out AUC out of range"
    for name in ("update_and_root_hist", "level_stream", "split_stream", "score_add"):
        assert counts[name] > 0, f"{name} was not launched on the main path"
    text = bst.model_to_string()

    os.environ["LIGHTGBM_TPU_LEVELGROW"] = "0"
    try:
        pk.reset_launch_counts()
        bst0, wall0 = run(2)
        c0 = pk.launch_counts()
    finally:
        del os.environ["LIGHTGBM_TPU_LEVELGROW"]
    log(f"full, level grower off: 2 iterations in {wall0:.2f} s; launches {json.dumps(c0)}; "
        f"same 2 trees as the level grower: "
        f"{bst0.model_to_string() == bst.model_to_string(num_iteration=2)}")
    assert c0["split_stream"] > 0 and c0["level_stream"] == 0
    del bst0
    if dev.type == "cuda":
        profile_iters(ds, dev)

    bst2, _ = run(iters)
    same = bst2.model_to_string() == text
    log(f"full: repeat run gives byte-identical model text: {same}")
    return counts, dict(s_iter=s_iter, auc=a, peak_gib=peak, deterministic=same)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--small-rows", type=int, default=200_000)
    ap.add_argument("--small-iters", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip()
    if smi.returncode != 0 or not card:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(card.splitlines()[0])  # the card's name and power limit, as nvidia-smi gives them
    sys.path.insert(0, HERE)
    from lightgbm_tpu_torch.ops import _build, pkernels as pk

    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path()})")

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    kern = phase_kernels(args.rows, dev)
    log(f"kernels checked in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_small(args.small_rows, args.small_iters, dev)
    log(f"small end to end in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, full = phase_full(args.rows, args.iters, dev)
    log(f"full width in {time.perf_counter() - t0:.1f} s")

    entries = []
    for name in ("update_and_root_hist", "level_stream", "split_stream", "score_add"):
        k = kern[name]
        entries.append(dict(name=name, route="cuda", source=SOURCES[name],
                            replaces=REPLACES[name], launches=counts[name],
                            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
                            bound_ms=k["bound_ms"], bound_by=k["bound_by"],
                            library_ms=k["library_ms"]))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
