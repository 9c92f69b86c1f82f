"""graftlint CLI — the port's runner of the project-native static
analysis suite (`deeplearning4j_tpu_torch/analysis`).

    python -m deeplearning4j_tpu_torch.tools.graftlint        # the port
    python -m deeplearning4j_tpu_torch.tools.graftlint --profile jax \
        deeplearning4j_tpu tools bench.py                     # reference
    python -m deeplearning4j_tpu_torch.tools.graftlint --json ... | jq .
    python -m deeplearning4j_tpu_torch.tools.graftlint --list-rules
    python -m deeplearning4j_tpu_torch.tools.graftlint --changed-only
    python -m deeplearning4j_tpu_torch.tools.graftlint --lock-graph g.json
    python -m deeplearning4j_tpu_torch.tools.graftlint --jobs 8 ...
    python -m deeplearning4j_tpu_torch.tools.graftlint \
        --write-baseline lint_baseline.json ...
    python -m deeplearning4j_tpu_torch.tools.graftlint \
        --baseline lint_baseline.json ...

``--profile torch`` (the default) lints the port's tree
(``deeplearning4j_tpu_torch/``) with the port's names: ``DL4J_CUDA_*``
knobs, CUDA graph captures as the compiled region. ``--profile jax``
reproduces the reference's analyzer exactly, with its default paths
(``deeplearning4j_tpu/``, ``tools/``, ``bench.py``).

Exit codes: 0 clean (or all findings baselined/suppressed), 2 on
unsuppressed findings, 1 on usage/internal error.

Suppression: ``# graftlint: disable=<rule>[,<rule>] -- <justification>``
on the flagged line (``disable-file=`` near the top of a file for
file-wide). The justification is REQUIRED; empty ones and stale pragmas
are findings themselves.

Baseline workflow (landing a NEW rule without blocking): run with
``--write-baseline lint_baseline.json`` once, commit the burn-down
file, and gate with ``--baseline lint_baseline.json`` — only NEW
findings fail; stale entries are reported so the file shrinks with the
debt.

The analyzer is stdlib-only and `import deeplearning4j_tpu_torch` imports
no layer of the port, so this runner starts without importing torch.
"""
import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import time

from deeplearning4j_tpu_torch import analysis
from deeplearning4j_tpu_torch.analysis import core as _core

ROOT = _core._ROOT

#: the paths each profile lints when none are given
DEFAULT_PATHS = {
    "torch": [os.path.join(ROOT, "deeplearning4j_tpu_torch")],
    "jax": [os.path.join(ROOT, "deeplearning4j_tpu"),
            os.path.join(ROOT, "tools"),
            os.path.join(ROOT, "bench.py")],
}


def _worker(chunk, select_list, profile):
    """Per-module rule pass over one chunk of files — runs in a pool
    worker. Project-wide rules, pragmas and parse-error reporting stay
    in the parent (core.run); workers return plain Finding lists, which
    pickle (no AST attached)."""
    select = set(select_list) if select_list is not None else None
    rules = [r for r in analysis.ALL_RULES
             if not isinstance(r, analysis.ProjectRule)
             and (select is None or r.name in select)
             and r.applies(profile)]
    out = []
    for path in chunk:
        mod = _core.load_module(path, profile)
        if mod is None:
            continue              # the parent reports parse errors itself
        findings = []
        for rule in rules:
            findings.extend(rule.check(mod))
        out.append((path, findings))
    return out


def _parallel_module_pass(files, select, jobs, profile):
    """Fan the per-module rules out over `jobs` processes; returns the
    path -> findings map core.run accepts, or None to run serially."""
    if jobs <= 1 or len(files) < 3 * jobs:
        return None
    select_list = sorted(select) if select is not None else None
    chunks = [files[i::jobs] for i in range(jobs)]
    merged = {}
    with concurrent.futures.ProcessPoolExecutor(max_workers=jobs) as ex:
        for result in ex.map(_worker, chunks,
                             [select_list] * len(chunks),
                             [profile] * len(chunks)):
            for path, findings in result:
                merged[path] = findings
    return merged


def _changed_files():
    """Repo-relative .py files that differ from HEAD (staged, unstaged,
    untracked) — the dev-loop scope for --changed-only."""
    out = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        proc = subprocess.run(args, capture_output=True, text=True,
                              cwd=ROOT, timeout=30)
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(args)} failed: {proc.stderr.strip()}")
        for line in proc.stdout.splitlines():
            line = line.strip()
            if line.endswith(".py"):
                out.add(os.path.abspath(os.path.join(ROOT, line)))
    return out


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftlint",
        description="project-native static analysis of the port "
                    "(README.md, \"The port's static analyzer\")")
    p.add_argument("paths", nargs="*",
                   help="files/dirs to lint (default: the profile's tree: "
                        "deeplearning4j_tpu_torch/ under torch; "
                        "deeplearning4j_tpu/, tools/, bench.py under jax)")
    p.add_argument("--profile", choices=analysis.PROFILES,
                   default=analysis.DEFAULT_PROFILE,
                   help="which framework's names the rules know: torch "
                        "(the port, default) or jax (the reference's "
                        "analyzer exactly)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable findings on stdout")
    p.add_argument("--select", metavar="RULES",
                   help="comma-separated rule names to run (default all)")
    p.add_argument("--baseline", metavar="FILE",
                   help="suppress findings recorded in FILE; only NEW "
                        "findings gate")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="snapshot current unsuppressed findings to FILE "
                        "and exit 0 (the burn-down workflow)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    p.add_argument("--lock-graph", metavar="PATH",
                   help="export the cross-module lock acquisition-order "
                        "graph (locks, held->acquired edges with call "
                        "chains, cycles) as JSON to PATH")
    p.add_argument("--changed-only", action="store_true",
                   help="lint only files changed vs HEAD (staged + "
                        "unstaged + untracked). Dev-loop scope: the "
                        "interprocedural rules see only the changed "
                        "subset; CI runs the full tree")
    p.add_argument("--jobs", type=int, default=None, metavar="N",
                   help="processes for the per-module rule pass "
                        "(default: min(8, cpu count); 1 = serial)")
    return p


def _list_rules(profile: str) -> int:
    print(f"profile: {profile}")
    for rule in analysis.ALL_RULES:
        print(f"{rule.name}")
        if not rule.applies(profile):
            print(f"    not applicable under the {profile} profile: "
                  f"{rule.not_applicable[profile]}")
        print(f"    {rule.summary}")
        print(f"    history: {rule.historical}")
    print(f"{analysis.PRAGMA_RULE}")
    print("    framework check: pragmas need non-empty justifications "
          "and must suppress something")
    print("parse-error")
    print("    framework check: an unreadable/unparseable file is a "
          "finding, never 'clean'")
    return 0


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.list_rules:
        return _list_rules(args.profile)
    if not args.paths:
        args.paths = DEFAULT_PATHS[args.profile]
    select = None
    if args.select:
        select = {s.strip() for s in args.select.split(",") if s.strip()}
        known = {r.name for r in analysis.ALL_RULES}
        bad = select - known
        if bad:
            print(f"graftlint: unknown rule(s): {', '.join(sorted(bad))}",
                  file=sys.stderr)
            return 1
    t0 = time.time()
    paths = list(args.paths)
    if args.changed_only:
        try:
            changed = _changed_files()
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            print(f"graftlint: --changed-only needs git: {e}",
                  file=sys.stderr)
            return 1
        paths = [f for f in analysis.iter_py_files(paths) if f in changed]
        if not paths:
            # clean working tree: a no-op scope is legitimately green
            # (unlike a typo'd path, which still errors below)
            print("graftlint: no changed Python files vs HEAD — "
                  "nothing to lint")
            if args.lock_graph:
                # loud, not silent: the requested artifact was NOT
                # (re)written — a consumer must not read a stale graph
                # behind a green exit
                print(f"graftlint: lock graph NOT written to "
                      f"{args.lock_graph} (no files analyzed; run "
                      "without --changed-only for the artifact)",
                      file=sys.stderr)
            return 0
    jobs = args.jobs if args.jobs is not None else min(
        8, os.cpu_count() or 1)
    try:
        files = analysis.iter_py_files(paths)
        module_findings = _parallel_module_pass(files, select, jobs,
                                                args.profile)
        result = analysis.run(paths, select=select,
                              module_findings=module_findings,
                              profile=args.profile)
    except OSError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 1
    if result.files == 0 and not result.findings:
        # a typo'd path must not read as a clean gate
        print("graftlint: no Python files under "
              f"{', '.join(args.paths)} — nothing was linted",
              file=sys.stderr)
        return 1
    if args.lock_graph:
        doc = result.project.concurrency().lock_graph_doc()
        tmp = args.lock_graph + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, args.lock_graph)
        # stderr under --json: stdout is the machine-readable stream
        print(f"graftlint: lock graph ({len(doc['locks'])} locks, "
              f"{len(doc['edges'])} edges, {len(doc['cycles'])} "
              f"cycle(s)) -> {args.lock_graph}",
              file=sys.stderr if args.json else sys.stdout)

    if args.write_baseline:
        if select is not None:
            print("graftlint: refusing --write-baseline with --select — "
                  "the file would silently drop the other rules' debt",
                  file=sys.stderr)
            return 1
        analysis.write_baseline(args.write_baseline, result)
        n = len(result.all_unsuppressed)
        print(f"graftlint: baselined {n} finding(s) -> "
              f"{args.write_baseline}")
        return 0

    gating = result.all_unsuppressed
    stale = []
    if args.baseline:
        try:
            gating, stale = analysis.apply_baseline(args.baseline, result)
        except (OSError, ValueError, KeyError) as e:
            print(f"graftlint: bad baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 1
        if select is not None:
            # a rule-filtered run cannot see the other rules' debt —
            # their baseline entries are NOT stale, just out of scope
            stale = []

    elapsed = time.time() - t0
    if args.json:
        payload = {
            "version": 1,
            "files": result.files,
            "elapsed_seconds": round(elapsed, 3),
            "findings": [
                {"rule": f.rule, "path": os.path.relpath(f.path, ROOT),
                 "line": f.line, "message": f.message}
                for f in gating],
            "suppressed": len(result.suppressed),
            "baselined": (len(result.all_unsuppressed) - len(gating)
                          if args.baseline else 0),
            "stale_baseline_entries": stale,
        }
        print(json.dumps(payload, indent=2))
    else:
        for f in gating:
            print(f.render(ROOT))
        for key in stale:
            print(f"stale baseline entry (fixed — rewrite the "
                  f"baseline to bank it): {key}")
        n, s = len(gating), len(result.suppressed)
        print(f"graftlint: {result.files} files, {n} finding(s)"
              + (f", {s} suppressed" if s else "")
              + (f", {len(result.all_unsuppressed) - n} baselined"
                 if args.baseline else "")
              + f" [{elapsed:.1f}s]")
    return 2 if gating else 0


if __name__ == "__main__":
    sys.exit(main())
