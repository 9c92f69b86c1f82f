#!/usr/bin/env python
"""Merge per-process trace segments into one Perfetto-loadable file.

The port's counterpart of the JAX package's `tools/trace_report.py`:
the same merge, ``--trace-id`` filter, summary and exit codes, over the
segments the port's `monitor` writes. It reads and writes JSON only (no
device, no ``--device``).

A fleet request crosses three crash domains — router, subprocess
replica, batcher/decode scheduler — and each process saves its own
Chrome trace-event JSON (`monitor.save_trace`; the serving CLI's
``--trace-out`` threads per-replica paths automatically:
``PATH`` for the router, ``PATH-stem.replica-N.json`` per replica).
This tool stitches those segments into ONE trace with named process
tracks, so a single ``trace_id`` reads top-to-bottom in ui.perfetto.dev:

    python -m deeplearning4j_tpu_torch.tools.trace_report \
        --out merged.json fleet.json fleet.replica-0.json fleet.replica-1.json

Inputs are paths or ``LABEL=path`` pairs (the label becomes the Perfetto
process name; default: the file's basename). Colliding pids across
files (container restarts, pid reuse) are remapped to keep every
process on its own track.

``--trace-id <hex>`` additionally prints that request's spans — per
process, in time order, with durations — and restricts the merged file
to the request's events plus track metadata: the "histogram exemplar ->
concrete trace" hop of the observability runbook.

Exit 0 on success; 2 for unreadable/invalid inputs (a typo'd CI
invocation must not read as green).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional, Tuple


def load_segment(path: str) -> List[dict]:
    """One trace file -> its event list. Accepts both the object form
    ({"traceEvents": [...]}) monitor.save_trace writes and a bare JSON
    array of events."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError(f"{path}: no traceEvents array")
        return events
    if isinstance(doc, list):
        return doc
    raise ValueError(f"{path}: not a Chrome trace-event document")


def merge_trace_segments(segments: List[Tuple[str, List[dict]]]) -> dict:
    """[(label, events)] -> one merged trace document. Each segment's
    pids get a process_name metadata track; a pid already claimed by an
    earlier segment is remapped (offset past the max seen) so two
    processes never share a track."""
    merged: List[dict] = []
    used_pids: set = set()
    max_pid = 0
    for label, events in segments:
        pids = {e.get("pid", 0) for e in events}
        remap: Dict[int, int] = {}
        for pid in sorted(pids):
            if pid in used_pids:
                max_pid += 1
                while max_pid in used_pids:
                    max_pid += 1
                remap[pid] = max_pid
            else:
                remap[pid] = pid
            used_pids.add(remap[pid])
            max_pid = max(max_pid, remap[pid])
        named = set()
        for e in events:
            pid = remap.get(e.get("pid", 0), e.get("pid", 0))
            if e.get("ph") == "M" and e.get("name") == "process_name":
                named.add(pid)
            e = dict(e)
            e["pid"] = pid
            merged.append(e)
        for pid in sorted(remap.values()):
            if pid not in named:
                merged.append({"name": "process_name", "ph": "M",
                               "pid": pid, "args": {"name": label}})
    return {"traceEvents": merged, "displayTimeUnit": "ms"}


def merge_trace_files(inputs) -> dict:
    """Paths or (label, path) pairs -> merged trace document."""
    segments = []
    for item in inputs:
        if isinstance(item, tuple):
            label, path = item
        else:
            label, path = None, item
        if label is None:
            label = os.path.splitext(os.path.basename(path))[0]
        segments.append((label, load_segment(path)))
    return merge_trace_segments(segments)


def events_for_trace(doc: dict, trace_id: str) -> List[dict]:
    """The merged doc's complete-span events carrying `trace_id`."""
    return [e for e in doc["traceEvents"]
            if e.get("ph") == "X"
            and (e.get("args") or {}).get("trace_id") == trace_id]


def filter_to_trace(doc: dict, trace_id: str) -> dict:
    """Merged doc restricted to one request: its events + the metadata
    tracks they live on (still a valid, loadable trace)."""
    keep = events_for_trace(doc, trace_id)
    keep += [e for e in doc["traceEvents"]
             if e.get("ph") == "i"
             and (e.get("args") or {}).get("trace_id") == trace_id]
    pids = {e["pid"] for e in keep}
    meta = [e for e in doc["traceEvents"]
            if e.get("ph") == "M" and e.get("pid") in pids]
    return {"traceEvents": meta + keep, "displayTimeUnit": "ms"}


def print_trace_summary(doc: dict, trace_id: str, out=sys.stdout):
    pnames = {e["pid"]: e["args"]["name"]
              for e in doc["traceEvents"]
              if e.get("ph") == "M" and e.get("name") == "process_name"}
    spans = events_for_trace(doc, trace_id)
    print(f"trace {trace_id}: {len(spans)} spans across "
          f"{len({e['pid'] for e in spans})} process(es)", file=out)
    for e in sorted(spans, key=lambda e: (e["pid"], e["ts"])):
        proc = pnames.get(e["pid"], str(e["pid"]))
        print(f"  {proc:<24} {e['name']:<28} "
              f"{e.get('dur', 0) / 1e3:9.3f} ms", file=out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("inputs", nargs="+", metavar="PATH|LABEL=PATH",
                   help="per-process trace files (monitor.save_trace "
                        "output); LABEL= names the Perfetto process "
                        "track")
    p.add_argument("--out", default=None,
                   help="merged trace path (default: print a summary "
                        "only)")
    p.add_argument("--trace-id", default=None,
                   help="print one request's cross-process span "
                        "timeline and restrict --out to it")
    args = p.parse_args(argv)

    pairs = []
    for item in args.inputs:
        label, sep, path = item.partition("=")
        pairs.append((label, path) if sep else (None, item))
    missing = [path for _, path in pairs if not os.path.isfile(path)]
    if missing:
        print(f"trace_report: no such input file(s): {missing}",
              file=sys.stderr)
        return 2
    try:
        doc = merge_trace_files(pairs)
    except (OSError, ValueError, KeyError) as e:
        print(f"trace_report: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    procs = {e["pid"] for e in doc["traceEvents"]}
    trace_ids = {(e.get("args") or {}).get("trace_id")
                 for e in spans} - {None}
    print(f"merged {len(pairs)} segment(s): {len(spans)} spans, "
          f"{len(procs)} process track(s), "
          f"{len(trace_ids)} distinct trace_id(s)")

    out_doc = doc
    if args.trace_id:
        print_trace_summary(doc, args.trace_id)
        out_doc = filter_to_trace(doc, args.trace_id)
        if not events_for_trace(out_doc, args.trace_id):
            print(f"trace_report: trace_id {args.trace_id!r} not found "
                  "in any segment", file=sys.stderr)
            return 2
    if args.out:
        tmp = f"{args.out}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(out_doc, f)
        os.replace(tmp, args.out)
        print(f"wrote {args.out} "
              f"({len(out_doc['traceEvents'])} events)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
