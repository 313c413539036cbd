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

  report merge <dir|trace.jsonl...>  the ranks' traces of one run over
                                    several processes as one timeline:
                                    iterations aligned across ranks, each
                                    split into compute and collective
                                    wait, the straggler and the wait
                                    behind it, bytes by purpose; warns
                                    when the files' run_ids disagree

Not ported yet, each raising NotImplementedError: ``report costs``
(waits for a torch form of the JAX package's ``obs/costmodel.py`` and
``compilewatch.JitWatch``) and ``report bench-trend`` (waits for the
port's benchmark).

The loaders skip torn or garbage lines (a run killed mid-write) with a
warning on stderr.  The record schema is the JAX package's, so either
package's ``report`` reads either package's traces.
"""

from __future__ import annotations

import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional

_NOT_YET = {
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


def net_bytes_by_purpose(records: List[Dict[str, Any]]) -> Dict[str, float]:
    """Total ``net.bytes`` counter value per purpose tag (``hist``,
    ``hist_q``, ``best_split``, ...) across a trace stream."""
    out: Dict[str, float] = {}
    for r in records:
        if r.get("ev") == "counter" and r.get("name") == "net.bytes":
            p = str(r.get("purpose", "misc"))
            out[p] = out.get(p, 0.0) + float(r.get("value", 0.0))
    return out


def quantized_wire_summary(purpose_bytes: Dict[str, float],
                           iters: int) -> Optional[Dict[str, Any]]:
    """Quantized-vs-f32 histogram payload accounting from the purpose
    ledger.  ``hist_q`` blobs are int16 (g,h) planes — by wire-format
    arithmetic the f32x3 payload for the SAME histograms is exactly 3x
    the bytes (F*B*12 vs F*B*4) — so the f32 equivalent is derivable
    without a second run.  Returns None when no histogram purpose was
    seen.  ``ratio`` is f32-equivalent over actually-sent histogram
    bytes: 1.0 for an unquantized run, approaching 3.0 when every
    histogram rides the quantized wire."""
    hq = purpose_bytes.get("hist_q", 0.0)
    hf = purpose_bytes.get("hist", 0.0)
    if hq <= 0 and hf <= 0:
        return None
    sent = hq + hf
    equiv = 3.0 * hq + hf
    n = max(iters, 1)
    return {
        "hist_q_bytes": int(hq),
        "hist_f32_bytes": int(hf),
        "hist_q_bytes_per_iter": round(hq / n, 1),
        "f32_equiv_bytes_per_iter": round(equiv / n, 1),
        "ratio": round(equiv / sent, 3) if sent > 0 else None,
    }



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


# ----------------------------------------------------------------------
# cross-rank merge (report merge <dir|files...>)
# ----------------------------------------------------------------------
def _rank_of(records: List[Dict[str, Any]], fallback: int) -> int:
    for r in records:
        if "rank" in r:
            return int(r["rank"])
    return fallback


def load_rank_traces(paths: List[str]) -> Dict[int, List[Dict[str, Any]]]:
    """Load per-rank trace files into {rank: records}.  Rank comes from
    the records themselves (the tracer stamps ``rank`` in multi-rank
    runs); files without a rank field fall back to their argument
    order, with a warning."""
    by_rank: Dict[int, List[Dict[str, Any]]] = {}
    for i, p in enumerate(sorted(paths)):
        recs = load_trace(p)
        rank = _rank_of(recs, fallback=i)
        if not any("rank" in r for r in recs):
            sys.stderr.write(
                f"warning: {p}: records carry no rank field; assuming "
                f"rank {rank} from argument order\n"
            )
        if rank in by_rank:
            sys.stderr.write(
                f"warning: {p}: duplicate rank {rank}; concatenating\n"
            )
            by_rank[rank].extend(recs)
        else:
            by_rank[rank] = recs
    return by_rank


def _iter_wait_s(phases: Dict[str, float]) -> float:
    """Barrier-wait attributed inside one iteration record.  net.barrier
    spans nest a net.allgather span and BOTH accumulate into the phases
    map, so take the max of the pair rather than their sum."""
    return max(float(phases.get("net.barrier", 0.0)),
               float(phases.get("net.allgather", 0.0)))


def _rank_net_wait_s(records: List[Dict[str, Any]]) -> float:
    """Total barrier/collective wait from this rank's span records:
    top-level net.barrier spans plus net.allgather spans that are NOT
    nested inside a barrier (double-count guard via the parent field)."""
    total = 0.0
    for r in records:
        if r.get("ev") != "span":
            continue
        name = r.get("name", "")
        if name == "net.barrier":
            total += float(r.get("dur_s", 0.0))
        elif name == "net.allgather" and r.get("parent") != "net.barrier":
            total += float(r.get("dur_s", 0.0))
    return total


def merge_summary(by_rank: Dict[int, List[Dict[str, Any]]]) -> Dict[str, Any]:
    """Cross-rank aggregation aligned on iteration boundaries.

    Per rank and per common iteration (present on EVERY rank — torn
    tails shrink the aligned window rather than skewing it):
    ``wall_s`` and its split into ``wait_s`` (the net.barrier /
    net.allgather share of the iteration) and ``compute_s`` (the rest).
    The straggler is the rank with the largest aligned compute total;
    ``slowest_rank_share`` is its share of fleet compute, and
    ``wait_behind_straggler_s`` is what every other rank spent parked
    in barriers — the time a rebalance could reclaim (ROADMAP item 3).
    """
    ranks = sorted(by_rank)
    run_ids = {r.get("run_id") for recs in by_rank.values()
               for r in recs if r.get("run_id") is not None}
    worlds = {int(r["world"]) for recs in by_rank.values()
              for r in recs if "world" in r}
    if len(run_ids) > 1:
        sys.stderr.write(
            f"warning: traces carry {len(run_ids)} distinct run_ids "
            f"{sorted(map(str, run_ids))} — are these files from one run?\n"
        )
    iters: Dict[int, Dict[int, Dict[str, float]]] = {}  # rank -> it -> rec
    phases: Dict[str, Dict[int, float]] = {}            # phase -> rank -> s
    for rank in ranks:
        per_it: Dict[int, Dict[str, float]] = {}
        for r in by_rank[rank]:
            if r.get("ev") != "iter":
                continue
            it = int(r.get("iter", -1))
            ph = r.get("phases") or {}
            wall = float(r.get("wall_s", 0.0))
            wait = min(_iter_wait_s(ph), wall)
            per_it[it] = {"wall_s": wall, "wait_s": wait,
                          "compute_s": wall - wait,
                          "net_bytes": float(r.get("net_bytes", 0.0))}
            for name, dur in ph.items():
                phases.setdefault(name, {})
                phases[name][rank] = phases[name].get(rank, 0.0) + float(dur)
        iters[rank] = per_it
    common = sorted(set.intersection(*(set(iters[r]) for r in ranks))
                    if ranks else set())
    timeline = []
    for it in common:
        walls = {r: iters[r][it]["wall_s"] for r in ranks}
        computes = {r: iters[r][it]["compute_s"] for r in ranks}
        slowest = max(ranks, key=lambda r: computes[r])
        timeline.append({
            "iter": it,
            "wall_s": {r: round(walls[r], 6) for r in ranks},
            "compute_s": {r: round(computes[r], 6) for r in ranks},
            "wait_s": {r: round(iters[r][it]["wait_s"], 6) for r in ranks},
            "slowest_rank": slowest,
        })
    per_rank = {}
    for rank in ranks:
        wall = sum(iters[rank][it]["wall_s"] for it in common)
        wait = sum(iters[rank][it]["wait_s"] for it in common)
        nbytes = sum(iters[rank][it]["net_bytes"] for it in common)
        per_rank[rank] = {
            "iterations": len(iters[rank]),
            "aligned_iterations": len(common),
            "wall_s": round(wall, 6),
            "compute_s": round(wall - wait, 6),
            "barrier_wait_s": round(wait, 6),
            "net_wait_total_s": round(_rank_net_wait_s(by_rank[rank]), 6),
            "net_bytes": int(nbytes),
            "bytes_per_iter": round(nbytes / len(common), 1) if common
            else 0.0,
        }
        # quantized-training wire accounting: per-rank histogram-payload
        # ratio (f32-equivalent / sent; 1.0 = unquantized, ->3.0 = fully
        # quantized) from the purpose-tagged net.bytes counters
        qw = quantized_wire_summary(
            net_bytes_by_purpose(by_rank[rank]), len(common))
        if qw is not None:
            per_rank[rank]["hist_q_bytes"] = qw["hist_q_bytes"]
            per_rank[rank]["quantized_ratio"] = qw["ratio"]
        # out-of-core streaming accounting (boosting/ooc.py gauges): how
        # long this rank's folds sat stalled on its prefetch ring —
        # attributes streaming stragglers the way barrier_wait_s
        # attributes compute stragglers
        ooc_stall = ooc_fetch = 0.0
        saw_ooc = False
        for r in by_rank[rank]:
            if r.get("ev") != "gauge":
                continue
            if r.get("name") == "ooc.stall_ms":
                ooc_stall += float(r.get("value", 0.0))
                saw_ooc = True
            elif r.get("name") == "ooc.fetch_ms":
                ooc_fetch += float(r.get("value", 0.0))
                saw_ooc = True
        if saw_ooc:
            per_rank[rank]["ooc_stall_s"] = round(ooc_stall / 1e3, 6)
            per_rank[rank]["ooc_fetch_s"] = round(ooc_fetch / 1e3, 6)
            per_rank[rank]["ooc_stall_share"] = (
                round(ooc_stall / (wall * 1e3), 4) if wall > 0 else None)
    out: Dict[str, Any] = {
        "ranks": ranks,
        "world_size": (sorted(worlds)[-1] if worlds else len(ranks)),
        "run_id": (sorted(map(str, run_ids))[0] if len(run_ids) == 1
                   else None),
        "aligned_iterations": len(common),
        "per_rank": per_rank,
        "phases": {
            name: {r: round(v, 6) for r, v in sorted(vals.items())}
            for name, vals in sorted(
                phases.items(),
                key=lambda kv: -sum(kv[1].values()))
        },
        "timeline": timeline,
    }
    if ranks and common:
        compute = {r: per_rank[r]["compute_s"] for r in ranks}
        total_compute = sum(compute.values())
        straggler = max(ranks, key=lambda r: compute[r])
        slowest_counts = [t["slowest_rank"] for t in timeline]
        out["straggler"] = {
            "rank": straggler,
            "slowest_rank_share": round(
                compute[straggler] / total_compute, 4
            ) if total_compute > 0 else None,
            "slowest_in_iters": slowest_counts.count(straggler),
            "wait_behind_straggler_s": round(
                sum(per_rank[r]["barrier_wait_s"]
                    for r in ranks if r != straggler), 6),
        }
    # shard-rebalance events (rebalance.plan, boosting/gbdt.py): per-rank
    # rows owned before/after each move, plus the fleet barrier-wait
    # share on either side of it — did the move actually reclaim wait?
    # Every rank emits the identical event; dedupe on the iteration.
    events: Dict[int, Dict[str, Any]] = {}
    for recs in by_rank.values():
        for r in recs:
            if r.get("ev") == "event" and r.get("name") == "rebalance.plan":
                events.setdefault(int(r.get("iter", -1)), r)
    if events:
        def _wait_share(its):
            wall = sum(iters[r][it]["wall_s"] for r in ranks for it in its)
            wait = sum(iters[r][it]["wait_s"] for r in ranks for it in its)
            return round(wait / wall, 4) if wall > 0 else None

        out["rebalance"] = []
        for ev_it in sorted(events):
            ev = events[ev_it]
            out["rebalance"].append({
                "iter": ev_it,
                "rows_before": [int(c) for c in ev.get("before", [])],
                "rows_after": [int(c) for c in ev.get("after", [])],
                "wait_share_before": _wait_share(
                    [it for it in common if it < ev_it]),
                "wait_share_after": _wait_share(
                    [it for it in common if it >= ev_it]),
            })
    return out


def render_merge(m: Dict[str, Any]) -> str:
    lines = []
    rid = f" run_id={m['run_id']}" if m.get("run_id") else ""
    lines.append(
        f"=== lightgbm_tpu cross-rank report: {len(m['ranks'])} rank(s), "
        f"world={m['world_size']}, {m['aligned_iterations']} aligned "
        f"iteration(s){rid} ===")
    ranks = m["ranks"]
    # quantized-wire column only when some rank exchanged histograms;
    # OOC stall column only when some rank streamed its bin matrix
    show_q = any("quantized_ratio" in m["per_rank"][r] for r in ranks)
    show_ooc = any("ooc_stall_s" in m["per_rank"][r] for r in ranks)
    lines.append("")
    lines.append(f"{'rank':<8}{'iters':>7}{'wall_s':>10}{'compute_s':>11}"
                 f"{'barrier_wait_s':>16}"
                 + (f"{'ooc_stall_s':>13}{'stall%':>8}" if show_ooc else "")
                 + f"{'bytes/iter':>12}"
                 + (f"{'q_ratio':>9}" if show_q else ""))
    for r in ranks:
        pr = m["per_rank"][r]
        qr = pr.get("quantized_ratio")
        os_ = pr.get("ooc_stall_s")
        osh = pr.get("ooc_stall_share")
        lines.append(f"{r:<8}{pr['aligned_iterations']:>7}"
                     f"{pr['wall_s']:>10.3f}{pr['compute_s']:>11.3f}"
                     f"{pr['barrier_wait_s']:>16.3f}"
                     + (((f"{os_:>13.3f}" if os_ is not None
                          else f"{'-':>13}")
                         + (f"{100.0 * osh:>7.1f}%" if osh is not None
                            else f"{'-':>8}"))
                        if show_ooc else "")
                     + f"{pr.get('bytes_per_iter', 0.0):>12.0f}"
                     + ((f"{qr:>9.2f}" if qr is not None else f"{'-':>9}")
                        if show_q else ""))
    st = m.get("straggler")
    if st:
        share = st["slowest_rank_share"]
        share_txt = f"{100.0 * share:.1f}% of fleet compute" \
            if share is not None else "n/a"
        lines.append("")
        lines.append(
            f"straggler: rank {st['rank']} — {share_txt}, slowest in "
            f"{st['slowest_in_iters']}/{m['aligned_iterations']} "
            f"iteration(s); other ranks spent "
            f"{st['wait_behind_straggler_s']:.3f} s in barrier wait")
    if m.get("rebalance"):
        lines.append("")
        lines.append(f"{'rebalance':<14}{'rows/rank before -> after':<40}"
                     f"{'wait share':>14}")
        for ev in m["rebalance"]:
            wb, wa = ev["wait_share_before"], ev["wait_share_after"]
            trend = (f"{wb:.2f} -> {wa:.2f}"
                     if wb is not None and wa is not None else "n/a")
            lines.append(
                f"{'@ iter ' + str(ev['iter']):<14}"
                f"{str(ev['rows_before']) + ' -> ' + str(ev['rows_after']):<40}"
                f"{trend:>14}")
    if m["phases"]:
        lines.append("")
        header = f"{'phase':<24}" + "".join(f"rank{r:>2}/s{'':>3}"
                                            for r in ranks)
        lines.append(header)
        for name, vals in m["phases"].items():
            row = f"{name:<24}" + "".join(
                f"{vals.get(r, 0.0):>10.3f}" for r in ranks)
            lines.append(row)
    return "\n".join(lines) + "\n"


def merge_main(argv: List[str]) -> int:
    args = [a for a in argv if not a.startswith("--")]
    as_json = "--json" in argv
    if not args:
        sys.stderr.write(
            "usage: python -m lightgbm_tpu_torch report merge <dir|trace.jsonl...>"
            " [--json]\n")
        return 2
    paths: List[str] = []
    for a in args:
        if os.path.isdir(a):
            paths.extend(p for p in glob.glob(os.path.join(a, "*.jsonl"))
                         if not p.endswith(".crash.jsonl"))
        else:
            paths.append(a)
    if not paths:
        sys.stderr.write(f"no trace files found under {args}\n")
        return 1
    try:
        by_rank = load_rank_traces(paths)
    except OSError as e:
        sys.stderr.write(f"cannot read traces: {e}\n")
        return 1
    m = merge_summary(by_rank)
    if as_json:
        sys.stdout.write(json.dumps(m) + "\n")
    else:
        sys.stdout.write(render_merge(m))
    return 0


# ----------------------------------------------------------------------
# stream diff (report diff a.jsonl b.jsonl)
# ----------------------------------------------------------------------
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
    """``python -m lightgbm_tpu_torch report {<trace.jsonl> | diff <a> <b> |
    merge <dir|files...>} [--json]``."""
    if argv and argv[0] in _NOT_YET:
        raise NotImplementedError(f"lightgbm_tpu_torch does not support report {argv[0]} "
                                  f"yet: {_NOT_YET[argv[0]]}")
    if argv and argv[0] == "diff":
        return diff_main(argv[1:])
    if argv and argv[0] == "merge":
        return merge_main(argv[1:])
    args = [a for a in argv if not a.startswith("--")]
    if not args:
        sys.stderr.write("usage: python -m lightgbm_tpu_torch report "
                         "{<trace.jsonl> | diff <a> <b> | merge <dir|files...>} [--json]\n")
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
