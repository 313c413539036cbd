#!/usr/bin/env python3
"""How elastic fleet members share one card: one member alone, eight
members at once, and one member beside seven CPU-bound Python processes.

    python3 chip_contention.py            # the three cases, ms a tree each
    python3 chip_contention.py --profile FILE  # also cProfile one member alone

Each member is ``python -m lightgbm_tpu_torch.factory.member_worker`` as a
fleet of one at the main cell's width (20,000 rows, 28 features of 63
values, 255 leaves, quantized binary, 4 trees) on the card; the script
prints each member's seconds a tree (its ``iter_s``).  With
``--profile FILE`` it runs one member in this process under cProfile and
writes the table to FILE.  Its other files go under ``build/contention/``.
"""

import argparse
import cProfile
import io
import json
import os
import pstats
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WIDTH = {"MEMBER_NPROC": "1", "MEMBER_ROWS": "20000", "MEMBER_FEATURES": "28",
         "MEMBER_MAX_BIN": "63", "MEMBER_LEAVES": "255", "MEMBER_TREES": "4",
         "LIGHTGBM_TPU_NET_TIMEOUT": "10"}


def spawn(work, tag):
    d = os.path.join(work, tag)
    os.makedirs(d)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("LIGHTGBM_TPU_", "MEMBER_"))}
    env.update(WIDTH, PYTHONPATH=HERE, OMP_NUM_THREADS="1")
    return d, subprocess.Popen([sys.executable, "-m", "lightgbm_tpu_torch.factory.member_worker",
                                "0", d, os.path.join(d, "out")], env=env, cwd=HERE)


def seconds_a_tree(d):
    with open(os.path.join(d, "out.m0.json")) as f:
        return [round(x, 3) for x in json.load(f)["iter_s"]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="FILE", help="cProfile one member alone into FILE")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_contention: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from lightgbm_tpu_torch.ops import _build

    _build.lib()
    work = os.path.join(HERE, "build", "contention")
    shutil.rmtree(work, ignore_errors=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    d, p = spawn(work, "alone")
    p.wait()
    print("alone", seconds_a_tree(d), flush=True)
    eight = [spawn(work, f"eight{i}") for i in range(8)]
    t = time.perf_counter()
    for _, p in eight:
        p.wait()
    print("eight at once", [seconds_a_tree(d) for d, _ in eight],
          round(time.perf_counter() - t, 1), flush=True)
    burners = [subprocess.Popen([sys.executable, "-c", "import time\nt = time.time()\n"
                                 "while time.time() - t < 90: pass"]) for _ in range(7)]
    try:
        d, p = spawn(work, "burn")
        p.wait()
        print("beside 7 CPU-bound processes", seconds_a_tree(d), flush=True)
    finally:
        for b in burners:
            b.kill()
    if args.profile:
        from lightgbm_tpu_torch.factory import member_worker

        os.environ.update(WIDTH)
        prof = cProfile.Profile()
        prof.enable()
        member_worker.main(["0", os.path.join(work, "profile"),
                            os.path.join(work, "profile", "out")])
        prof.disable()
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(30)
        os.makedirs(os.path.dirname(os.path.abspath(args.profile)), exist_ok=True)
        with open(args.profile, "w") as f:
            f.write(out.getvalue())
        print("profiled alone", seconds_a_tree(os.path.join(work, "profile")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
