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
- CUDA-event milliseconds (median) of update_and_root_hist,
  level_stream (one segment of all rows) and split_stream (the root
  segment) at 10.5M x 28 features, 64 and 256 bins.
"""

import argparse
import os
import sys

import numpy as np

TRAIN_ROWS, KERNEL_ROWS = 3_000_000, 10_500_000
ITERS = {63: 12, 255: 6}  # max_bin: iterations


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree")
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

    # ---- kernels at 64 and 256 bins
    F, n = 28, KERNEL_ROWS
    rng = np.random.default_rng(11)
    label = (rng.random(n) < 0.5).astype(np.float32)
    obj = create_objective(Config.from_params({"objective": "binary"}))
    md = Metadata(n)
    md.set_label(label)
    obj.init(md, n)
    delta = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1).to(dev)
    for B in (64, 256):
        lay = pk.PLayout(F)
        P = pk.pack_matrix(rng.integers(0, B, size=(n, F), dtype=np.uint8), lay, label=label,
                           device=dev)
        kw = dict(num_rows=n, num_features=F, num_bins=B, bits=8)
        upd = cs.time_cuda(lambda: pk.update_and_root_hist(P, lay, obj, delta=delta, **kw), 10)
        thr = B // 2 - 1
        tab = np.zeros((8, 12), np.int64)
        tab[0] = [0, n, 1, 16, 0, 0, thr, 0, 0, 256, 0, 0]
        lvl = cs.time_cuda(lambda: pk.level_stream(P, torch.from_numpy(tab), 1, num_features=F,
                                                   num_bins=B, bits=8, smax=8), 10)
        spl = cs.time_cuda(lambda: pk.split_stream(P, 0, n, 1, 16, 0, 0, thr, 0, num_features=F,
                                                   num_bins=B, bits=8), 10)
        print(f"AB {tree} kernels rows {n} bins {B}: update_and_root_hist {upd:.4f} ms, "
              f"level_stream {lvl:.4f} ms, split_stream {spl:.4f} ms", flush=True)
        del P
        torch.cuda.empty_cache()

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
