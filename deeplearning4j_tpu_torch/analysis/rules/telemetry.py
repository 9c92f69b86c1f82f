"""Rules: telemetry-zero-cost + metric-family-registration.

telemetry-zero-cost: the monitor layer's hard contract (monitor/trace.py
docstring) is zero cost while disabled. Two ways call sites break it:

- telemetry INSIDE a compiled region records at trace time only (or
  forces a retrace) — it can never observe runtime behavior (torch
  profile: inside a CUDA graph capture it runs at capture time only);
- ``span(..., attr=expensive())`` evaluates the attr EAGERLY even while
  tracing is disabled — ``span("step", loss=float(loss))`` puts a
  device->host sync on the always-on path. Expensive attrs belong under
  ``if monitor.tracing_enabled():``.

metric-family-registration: every emitted ``*_total``/``*_seconds``
family must appear in docs/OBSERVABILITY.md's catalog — the catalog is
the operator's contract (dashboards, alerts), and an uncataloged family
is invisible in practice. The extraction half
(`extract_metric_families`) is the one the reference's
tools/telemetry_smoke.py reads, so the static catalog check and a
live-scrape check read one source of truth.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Tuple

from deeplearning4j_tpu_torch.analysis.core import (
    Finding, ModuleInfo, Rule, iter_py_files, load_module,
)
from deeplearning4j_tpu_torch.analysis.rules._jax import (
    compiled_regions, walk_region,
)

_METRIC_FNS = {"counter", "gauge", "histogram"}
_SPAN_FNS = {"span", "add_span", "instant"}
#: flight-recorder record calls (monitor/flight.py): same
#: zero-cost-when-disabled contract, same compiled-region ban — a
#: flight.note() traced into an XLA program records once at trace time.
#: Generic base names, so these additionally require "flight" in the
#: resolved dotted name (a random obj.note() must not match).
_FLIGHT_FNS = {"begin", "note", "finish", "trip", "record"}
#: calls allowed in span attrs without a tracing_enabled() guard: O(1),
#: never a device sync (str/repr of host objects included — error paths
#: stringify their exception)
_CHEAP_CALLS = {"len", "str", "repr", "type"}


def _monitor_call(mod: ModuleInfo, call: ast.Call, kinds) -> Optional[str]:
    """The kind name when `call` is a monitor-layer call of one of
    `kinds` (resolved through imports; `self.x` excluded)."""
    name = mod.call_name(call)
    if not name or name.startswith("self."):
        return None
    base = name.split(".")[-1]
    if base not in kinds:
        return None
    if base in _FLIGHT_FNS and base not in (_METRIC_FNS | _SPAN_FNS):
        return base if "flight" in name else None
    if "monitor" in name or "metrics" in name or "trace" in name:
        return base
    return None


def _literal_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class TelemetryZeroCostRule(Rule):
    name = "telemetry-zero-cost"
    summary = ("span()/metric emission inside compiled regions, or "
               "expensive span attrs not behind tracing_enabled()")
    historical = ("zero-cost-when-disabled is the monitor layer's "
                  "hard contract — an eager float(loss) in span attrs "
                  "reintroduces the per-step sync the contract exists "
                  "to prevent")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        regions = compiled_regions(mod)
        in_region = set()
        for fn, why in regions.items():
            for node in walk_region(fn):
                if isinstance(node, ast.Call):
                    kind = _monitor_call(
                        mod, node,
                        _METRIC_FNS | _SPAN_FNS | _FLIGHT_FNS)
                    if kind:
                        in_region.add(id(node))
                        yield self.finding(
                            mod, node,
                            f"{kind}() inside a captured region ({why}) "
                            "— telemetry in a captured step runs once at "
                            "capture time and never on a replay; emit "
                            "from the host loop around the replay"
                            if mod.profile == "torch" else
                            f"{kind}() inside a compiled region ({why}) "
                            "— telemetry in traced code records once at "
                            "trace time and never again; emit from the "
                            "host loop around the compiled call")
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or id(node) in in_region:
                continue
            if _monitor_call(mod, node, _SPAN_FNS) is None:
                continue
            expensive = [kw for kw in node.keywords
                         if kw.arg is not None
                         and self._is_expensive(mod, kw.value)]
            if expensive and not self._guarded(mod, node):
                names = ", ".join(kw.arg for kw in expensive)
                yield self.finding(
                    mod, node,
                    f"span attr(s) {names} call functions and are "
                    "evaluated even while tracing is disabled — guard "
                    "the block with `if monitor.tracing_enabled():` or "
                    "pass precomputed values (zero-cost contract, "
                    "monitor/trace.py)")

    @staticmethod
    def _is_expensive(mod: ModuleInfo, expr: ast.AST) -> bool:
        from deeplearning4j_tpu_torch.analysis.rules.hotpath import (
            _mentions_static_only, _static_attrs,
        )
        attrs = _static_attrs(mod)
        for sub in ast.walk(expr):
            if not isinstance(sub, ast.Call):
                continue
            name = (mod.call_name(sub) or "").split(".")[-1]
            if name in _CHEAP_CALLS:
                continue
            # torch metadata methods: x.numel(), x.dim(), x.size(0)
            if mod.profile == "torch" and name in attrs:
                continue
            # int(x.shape[0]) / float(len(xs)): static facts, no sync
            if name in ("int", "float", "bool") and sub.args and all(
                    _mentions_static_only(a, attrs)
                    or isinstance(a, ast.Constant)
                    for a in sub.args):
                continue
            return True
        return False

    @staticmethod
    def _guarded(mod: ModuleInfo, node: ast.AST) -> bool:
        for anc in mod.ancestors(node):
            if isinstance(anc, ast.If):
                for sub in ast.walk(anc.test):
                    if isinstance(sub, ast.Call) and (
                            mod.call_name(sub) or "").endswith(
                                "tracing_enabled"):
                        return True
        return False


# ------------------------------------------------------------ extraction
def metric_families_in(mod: ModuleInfo) -> List[Tuple[str, int]]:
    """(family-name, line) for every literal-named monitor metric
    emission in the module (the source of truth a live-scrape check
    reads)."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if _monitor_call(mod, node, _METRIC_FNS) is None:
            continue
        if not node.args:
            continue
        name = _literal_str(node.args[0])
        if name:
            out.append((name, node.lineno))
    return out


def extract_metric_families(paths) -> Dict[str, List[Tuple[str, int]]]:
    """family-name -> [(path, line), ...] across a source tree."""
    out: Dict[str, List[Tuple[str, int]]] = {}
    for path in iter_py_files(paths):
        mod = load_module(path)
        if mod is None:
            continue
        for name, line in metric_families_in(mod):
            out.setdefault(name, []).append((path, line))
    return out


def _find_catalog(start: str) -> Optional[str]:
    cur = os.path.abspath(os.path.dirname(start))
    for _ in range(12):
        cand = os.path.join(cur, "docs", "OBSERVABILITY.md")
        if os.path.isfile(cand):
            return cand
        nxt = os.path.dirname(cur)
        if nxt == cur:
            break
        cur = nxt
    return None


class MetricFamilyRegistrationRule(Rule):
    name = "metric-family-registration"
    summary = ("emitted *_total/*_seconds metric families must appear "
               "in the docs/OBSERVABILITY.md catalog")
    historical = ("the catalog is the operator contract — an "
                  "uncataloged family exists on /metrics but in no "
                  "dashboard or alert")

    #: injectable for tests; default: walk up from the flagged file
    catalog_path: Optional[str] = None

    def __init__(self, catalog_path: Optional[str] = None):
        if catalog_path is not None:
            self.catalog_path = catalog_path
        self._cache: Dict[str, str] = {}

    def _catalog_text(self, for_file: str) -> Optional[str]:
        path = self.catalog_path or _find_catalog(for_file)
        if path is None:
            return None
        if path not in self._cache:
            try:
                with open(path, encoding="utf-8") as fh:
                    self._cache[path] = fh.read()
            except OSError:
                self._cache[path] = ""
        return self._cache[path]

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        families = [(n, ln) for n, ln in metric_families_in(mod)
                    if n.endswith(("_total", "_seconds"))]
        if not families:
            return
        catalog = self._catalog_text(mod.path)
        if catalog is None:
            return   # no docs tree in reach (fixture sandboxes)
        for name, line in families:
            if name not in catalog:
                yield Finding(
                    rule=self.name, path=mod.path, line=line,
                    message=f"metric family {name!r} is emitted but "
                    "missing from docs/OBSERVABILITY.md's catalog — "
                    "document it (operators alert on the catalog, not "
                    "the code)")
