"""Render an obs JSONL run log into per-stage / per-link summary tables
(a copy of the JAX package's ``obs/report.py``: the same text from the
same file).

  PYTHONPATH=src python -m repro_torch.obs.report runlog.jsonl
  PYTHONPATH=src python -m repro_torch.obs.report runlog.jsonl \
      --bench BENCH_pipeline.json

Sections:
  * run meta          — the configure-time metadata record(s)
  * spans             — per-stage latency attribution: count, mean,
                        p50, p95, max, total wall seconds per span name
  * links             — per-client/per-link byte accounting (raw vs
                        wire bytes, quant state, per-step aggregate;
                        when the run recorded a runtime participation
                        mask, the aggregate is also shown weighted by
                        it — the wire traffic a dropout/straggler run
                        actually moved)
  * faults            — ``fault/*`` events from a chaos run, grouped by
                        kind with the steps they fired at. Injections
                        (``fault/nan_batch``, ``fault/producer_crash``,
                        ...) read next to their recoveries
                        (``fault/step_skipped``,
                        ``fault/prefetch_restart``,
                        ``fault/ckpt_retry``) — a healthy chaos run
                        pairs every injection with a recovery and the
                        span/link tables look like a clean run's
  * counters / gauges — final totals and last-seen gauge values
  * histograms        — recorder-side aggregations (step wall time)
  * events            — error events in full, info events counted
  * bench             — optional BENCH_pipeline.json steps/sec
                        trajectory next to the measured spans

Rotated logs (``obs.configure(..., max_bytes=...)``) keep the overflow
in ``<path>.1``; render it separately — each file re-opens with the
run's meta record, so both halves are self-describing.
"""
from __future__ import annotations

import argparse
import json
from typing import Any, Dict, Iterable, List


def load_records(path: str) -> List[Dict[str, Any]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                out.append({"kind": "corrupt", "raw": line[:200]})
    return out


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GB"


def _table(rows: List[List[str]], header: List[str]) -> List[str]:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    lines = [fmt.format(*header), fmt.format(*["-" * w for w in widths])]
    lines += [fmt.format(*[str(c) for c in r]) for r in rows]
    return lines


def summarize_spans(records: Iterable[Dict[str, Any]]
                    ) -> Dict[str, Dict[str, float]]:
    durs: Dict[str, List[float]] = {}
    for r in records:
        if r.get("kind") == "span":
            durs.setdefault(r["name"], []).append(float(r["dur_s"]))
    out = {}
    for name, vals in durs.items():
        vals.sort()
        out[name] = {
            "count": len(vals),
            "mean_s": sum(vals) / len(vals),
            "p50_s": _pct(vals, 0.50),
            "p95_s": _pct(vals, 0.95),
            "max_s": vals[-1],
            "total_s": sum(vals),
        }
    return out


def summarize_links(records: Iterable[Dict[str, Any]]
                    ) -> Dict[str, Dict[str, Any]]:
    links: Dict[str, Dict[str, Any]] = {}
    for r in records:
        if r.get("kind") == "link":
            links[r["name"]] = r          # last record per link wins
    return links


def render(records: List[Dict[str, Any]],
           bench: Dict[str, Any] = None) -> str:
    lines: List[str] = []

    metas = [r for r in records if r.get("kind") == "meta"]
    for m in metas:
        lines.append(f"run {m.get('run_id', '?')}: "
                     + json.dumps(m.get("fields", {}), sort_keys=True))
    if not metas:
        lines.append("(no meta record)")

    spans = summarize_spans(records)
    lines += ["", "== spans (per-stage wall-clock latency) =="]
    if spans:
        rows = [[n, s["count"], f"{s['mean_s'] * 1e3:.2f}",
                 f"{s['p50_s'] * 1e3:.2f}", f"{s['p95_s'] * 1e3:.2f}",
                 f"{s['max_s'] * 1e3:.2f}", f"{s['total_s']:.3f}"]
                for n, s in sorted(spans.items())]
        lines += _table(rows, ["span", "count", "mean_ms", "p50_ms",
                               "p95_ms", "max_ms", "total_s"])
    else:
        lines.append("(none)")

    links = summarize_links(records)
    lines += ["", "== links (per-client byte accounting) =="]
    if links:
        rows = []
        step_total = 0
        for name, l in sorted(links.items()):
            wire = l.get("wire_bytes_per_client")
            if l.get("per_step") and wire is not None:
                step_total += wire * l.get("n_clients", 1)
            quant = ("-" if not l.get("compressed") else
                     ("traced" if l.get("quantized_in_trace")
                      else "configured"))
            rows.append([
                name, l.get("direction", "?"), l.get("n_clients", "?"),
                _fmt_bytes(l.get("raw_bytes_per_client")),
                _fmt_bytes(wire),
                f"int{l['bits']}" if l.get("compressed") else
                str(l.get("dtype", "?")),
                quant,
                "per-step" if l.get("per_step") else "one-time",
            ])
        lines += _table(rows, ["link", "dir", "clients", "raw/client",
                               "wire/client", "format", "quant", "cadence"])
        lines.append(f"per-step wire total (all clients): "
                     f"{_fmt_bytes(step_total)}")
        part = [r for r in records if r.get("kind") == "gauge"
                and r.get("name") == "comm/participation_frac"]
        if part:
            frac = float(part[-1]["value"])
            lines.append(
                f"per-step wire total x participation "
                f"(mask-aware, frac={frac:.3f}): "
                f"{_fmt_bytes(step_total * frac)}")
    else:
        lines.append("(none)")

    fault_events: Dict[str, List] = {}
    for r in records:
        if (r.get("kind") == "event"
                and str(r.get("name", "")).startswith("fault/")):
            fault_events.setdefault(r["name"], []).append(
                r.get("fields", {}).get("step"))
    if fault_events:
        lines += ["", "== faults (injections & recoveries) =="]
        for name, steps in sorted(fault_events.items()):
            shown = ",".join(str(s) for s in steps[:12] if s is not None)
            more = f" (+{len(steps) - 12} more)" if len(steps) > 12 else ""
            lines.append(f"{name}: x{len(steps)}"
                         + (f" @ steps {shown}{more}" if shown else ""))

    counters: Dict[str, Any] = {}
    gauges: Dict[str, Any] = {}
    for r in records:
        if r.get("kind") == "counter":
            counters[r["name"]] = r.get("total", r.get("value"))
        elif r.get("kind") == "gauge":
            gauges[r["name"]] = r.get("value")
    if counters or gauges:
        lines += ["", "== counters (totals) / gauges (last) =="]
        for n, v in sorted(counters.items()):
            lines.append(f"counter {n} = {v}")
        for n, v in sorted(gauges.items()):
            lines.append(f"gauge   {n} = {v}")

    hists = [r for r in records if r.get("kind") == "hist"]
    seen_hist = {}
    for h in hists:
        seen_hist[h["name"]] = h          # last emission wins
    if seen_hist:
        lines += ["", "== histograms =="]
        for n, h in sorted(seen_hist.items()):
            mean = h["sum"] / h["count"] if h.get("count") else 0.0
            lines.append(f"{n}: n={h.get('count')} mean={mean:.6g} "
                         f"min={h.get('min'):.6g} max={h.get('max'):.6g}")

    errors = [r for r in records
              if r.get("kind") == "event" and r.get("level") == "error"]
    infos = sum(1 for r in records
                if r.get("kind") == "event" and r.get("level") != "error")
    lines += ["", f"== events ({infos} info, {len(errors)} error) =="]
    for e in errors:
        lines.append(f"ERROR {e['name']}: "
                     + json.dumps(e.get("fields", {}), sort_keys=True))

    if bench:
        lines += ["", "== bench trajectory (BENCH_pipeline.json) =="]
        rows = [[e.get("cell", "?"), e.get("variant", "?"),
                 e.get("steps_per_sec", "?"),
                 f"{e.get('host_stall_frac', 0):.1%}"]
                for e in bench.get("entries", [])]
        lines += _table(rows, ["cell", "variant", "steps/s", "host_stall"])

    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Render an obs JSONL run log into summary tables.")
    p.add_argument("runlog", help="path to the JSONL run log")
    p.add_argument("--bench", default=None,
                   help="BENCH_pipeline.json to append as a trajectory")
    args = p.parse_args(argv)
    records = load_records(args.runlog)
    bench = None
    if args.bench:
        with open(args.bench) as f:
            bench = json.load(f)
    print(render(records, bench=bench))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
