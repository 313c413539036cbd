"""Trace-file reports — ``python -m lightgbm_tpu_torch report ...``, the
PyTorch-port copy of lightgbm_tpu/obs/report.py.

  report <trace.jsonl> [--json]     TIMETAG-style summary of one trace:
                                    per-phase totals, per-iteration
                                    stats, compiles, memory watermarks,
                                    checkpoints
  report diff <a.jsonl> <b.jsonl>   the first record where two JSONL
                                    streams differ — made for the
                                    LIGHTGBM_TPU_AUDIT trail, where it
                                    names the first divergent (iteration,
                                    leaf, feature, threshold, gain); exit
                                    1 on divergence, like diff(1)

Not ported yet, each raising NotImplementedError: ``report merge`` (the
cross-rank timeline; waits for the port's distributed training),
``report costs`` (waits for a torch form of the JAX package's
``obs/costmodel.py`` and ``compilewatch.JitWatch``) and ``report
bench-trend`` (waits for the port's benchmark).

The loaders skip torn or garbage lines (a run killed mid-write) with a
warning on stderr.  The record schema is the JAX package's, so either
package's ``report`` reads either package's traces.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional

_NOT_YET = {
    "merge": "the cross-rank merge waits for the port's distributed training",
    "costs": ("the cost report waits for a torch form of obs/costmodel.py and "
              "compilewatch.JitWatch"),
    "bench-trend": "the benchmark trend waits for the port's benchmark",
}


def load_trace(path: str, warn: bool = True, rotated: bool = True) -> List[Dict[str, Any]]:
    """The records of a JSONL trace (``<path>.1`` first when the sink was
    rotated), skipping unparsable lines with a warning."""
    paths = [path]
    if rotated and os.path.exists(path + ".1"):
        paths.insert(0, path + ".1")
    records = []
    for p in paths:
        with open(p) as f:
            for ln, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    rec = None
                if not isinstance(rec, dict):
                    if warn:
                        sys.stderr.write(f"warning: {p}:{ln}: skipping unparsable record "
                                         f"(torn tail from a killed run?)\n")
                    continue
                records.append(rec)
    return records


def summarize(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One trace's summary.  ``compiles`` sums the iteration records'
    ``compiles`` (the port's graph captures and lazy builds inside
    iterations; the JAX package's XLA compiles inside iterations)."""
    spans: Dict[str, List[float]] = {}
    iters: List[Dict[str, Any]] = []
    peak_host = peak_dev = 0.0
    saves: List[Dict[str, Any]] = []
    for r in records:
        ev = r.get("ev")
        if ev == "span":
            agg = spans.setdefault(r.get("name", "?"), [0.0, 0])
            agg[0] += float(r.get("dur_s", 0.0))
            agg[1] += 1
        elif ev == "iter":
            iters.append(r)
            peak_host = max(peak_host, float(r.get("host_rss_mb", 0.0)))
            peak_dev = max(peak_dev, float(r.get("dev_mb", 0.0)))
        elif ev == "event" and r.get("name") == "ckpt.saved":
            saves.append(r)
    phase_totals: Dict[str, Dict[str, float]] = {}
    for it in iters:
        for k, v in (it.get("phases") or {}).items():
            agg = phase_totals.setdefault(k, {"total_s": 0.0, "count": 0})
            agg["total_s"] += float(v)
            agg["count"] += 1
    walls = [float(it.get("wall_s", 0.0)) for it in iters]
    out = {
        "iterations": len(iters),
        "total_iter_wall_s": round(sum(walls), 6),
        "mean_s_per_iter": round(sum(walls) / len(walls), 6) if walls else None,
        "phases": {
            k: {"total_s": round(v["total_s"], 6), "count": v["count"],
                "mean_ms": round(1e3 * v["total_s"] / max(v["count"], 1), 3)}
            for k, v in sorted(phase_totals.items(), key=lambda kv: -kv[1]["total_s"])
        },
        "spans": {
            k: {"total_s": round(t, 6), "count": c, "mean_ms": round(1e3 * t / max(c, 1), 3)}
            for k, (t, c) in sorted(spans.items(), key=lambda kv: -kv[1][0])
        },
        "compiles": int(sum(int(it.get("compiles", 0) or 0) for it in iters)),
        "peak_host_rss_mb": round(peak_host, 1),
        "peak_dev_mb": round(peak_dev, 1),
    }
    if saves:
        out["checkpoints"] = {"saves": len(saves), "last_iter": int(saves[-1].get("iter", -1)),
                              "last_bytes": int(saves[-1].get("bytes", 0))}
    if iters:
        last = iters[-1]
        out["last_iter"] = int(last.get("iter", -1))
        if "leaves" in last:
            out["leaves_last_iter"] = last["leaves"]
    return out


def top_phases_line(summary: Dict[str, Any], k: int = 3) -> str:
    """The top-``k`` phases by share of the summed phase time, as one
    line; empty when the trace has no phase records."""
    phases = summary.get("phases") or {}
    total = sum(v["total_s"] for v in phases.values())
    if not phases or total <= 0:
        return ""
    ranked = sorted(phases.items(), key=lambda kv: -kv[1]["total_s"])[:k]
    return "top phases: " + " | ".join(f"{name} {100.0 * v['total_s'] / total:.1f}%"
                                       for name, v in ranked)


def render(summary: Dict[str, Any], path: str = "") -> str:
    """TIMETAG-style text table."""
    lines = [f"=== lightgbm_tpu_torch run-trace report{': ' + path if path else ''} ==="]
    n = summary["iterations"]
    if n:
        lines.append(f"iterations: {n}   iter wall total: {summary['total_iter_wall_s']:.3f} s"
                     f"   mean: {1e3 * summary['mean_s_per_iter']:.2f} ms/iter")
    else:
        lines.append("iterations: 0 (no iter records — run died before training?)")
    total_wall = summary["total_iter_wall_s"] or 0.0
    if summary["phases"]:
        top = top_phases_line(summary)
        if top:
            lines.append(top)
        lines.append("")
        lines.append(f"{'phase (per-iteration)':<28}{'total_s':>10}{'count':>8}"
                     f"{'mean_ms':>10}{'% iter':>8}")
        for name, s in summary["phases"].items():
            pct = 100.0 * s["total_s"] / total_wall if total_wall else 0.0
            lines.append(f"{name:<28}{s['total_s']:>10.3f}{s['count']:>8}"
                         f"{s['mean_ms']:>10.2f}{pct:>8.1f}")
    if summary["spans"]:
        lines.append("")
        lines.append(f"{'span':<28}{'total_s':>10}{'count':>8}{'mean_ms':>10}")
        for name, s in list(summary["spans"].items())[:20]:
            lines.append(f"{name:<28}{s['total_s']:>10.3f}{s['count']:>8}{s['mean_ms']:>10.2f}")
    lines.append("")
    lines.append(f"compiles (CUDA graph captures and lazy builds in iterations): "
                 f"{summary['compiles']}")
    lines.append(f"memory watermarks: host RSS {summary['peak_host_rss_mb']:.0f} MB"
                 + (f", device {summary['peak_dev_mb']:.0f} MB" if summary["peak_dev_mb"]
                    else ""))
    ck = summary.get("checkpoints")
    if ck:
        lines.append(f"checkpoints: {ck['saves']} saved, the last at iteration "
                     f"{ck['last_iter']} ({ck['last_bytes']} bytes)")
    return "\n".join(lines) + "\n"


def first_divergence(a: List[Dict[str, Any]],
                     b: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The first record index where the streams differ, with the fields
    that differ; None when identical.  A shorter stream diverges at its
    end (its record None)."""
    for i in range(max(len(a), len(b))):
        ra = a[i] if i < len(a) else None
        rb = b[i] if i < len(b) else None
        if ra == rb:
            continue
        fields = []
        if ra is not None and rb is not None:
            fields = [k for k in sorted(set(ra) | set(rb)) if ra.get(k) != rb.get(k)]
        return {"index": i, "a": ra, "b": rb, "fields": fields}
    return None


def render_divergence(div: Dict[str, Any], pa: str, pb: str) -> str:
    a, b = div["a"], div["b"]
    lines = [f"streams diverge at record {div['index']}:"]
    if a is None or b is None:
        short, path = ("a", pa) if a is None else ("b", pb)
        lines.append(f"  {short} ({path}) ends early; the other stream continues with: "
                     f"{json.dumps(b if a is None else a)}")
        return "\n".join(lines) + "\n"
    ctx = {k: a[k] for k in ("ev", "it", "k", "s", "leaf") if k in a}
    if ctx:
        lines.append("  at " + " ".join(f"{k}={v}" for k, v in ctx.items()))
    for k in div["fields"]:
        va, vb = a.get(k), b.get(k)
        if isinstance(va, list) and isinstance(vb, list) and len(va) == len(vb):
            # per-leaf values: name the first differing index
            for i, (xa, xb) in enumerate(zip(va, vb)):
                if xa != xb:
                    lines.append(f"  {k}[{i}]: a={json.dumps(xa)}  b={json.dumps(xb)}")
            continue
        lines.append(f"  {k}: a={json.dumps(va)}  b={json.dumps(vb)}")
    return "\n".join(lines) + "\n"


def diff_main(argv: List[str]) -> int:
    args = [a for a in argv if not a.startswith("--")]
    as_json = "--json" in argv
    if len(args) != 2:
        sys.stderr.write("usage: python -m lightgbm_tpu_torch report diff <a.jsonl> <b.jsonl> "
                         "[--json]\n")
        return 2
    pa, pb = args
    try:
        a, b = load_trace(pa), load_trace(pb)
    except OSError as e:
        sys.stderr.write(f"cannot read stream: {e}\n")
        return 2
    div = first_divergence(a, b)
    if div is None:
        sys.stdout.write(json.dumps({"identical": True, "records": len(a)}) + "\n" if as_json
                         else f"streams identical ({len(a)} records)\n")
        return 0
    sys.stdout.write(json.dumps({"identical": False, **div}) + "\n" if as_json
                     else render_divergence(div, pa, pb))
    return 1


def main(argv: List[str]) -> int:
    """``python -m lightgbm_tpu_torch report {<trace.jsonl> | diff <a> <b>}
    [--json]``."""
    if argv and argv[0] in _NOT_YET:
        raise NotImplementedError(f"lightgbm_tpu_torch does not support report {argv[0]} "
                                  f"yet: {_NOT_YET[argv[0]]}")
    if argv and argv[0] == "diff":
        return diff_main(argv[1:])
    args = [a for a in argv if not a.startswith("--")]
    if not args:
        sys.stderr.write("usage: python -m lightgbm_tpu_torch report "
                         "{<trace.jsonl> | diff <a> <b>} [--json]\n")
        return 2
    path = args[0]
    try:
        records = load_trace(path)
    except OSError as e:
        sys.stderr.write(f"cannot read trace {path}: {e}\n")
        return 1
    summary = summarize(records)
    sys.stdout.write(json.dumps(summary) + "\n" if "--json" in argv else render(summary, path))
    return 0
