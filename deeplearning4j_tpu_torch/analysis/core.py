"""graftlint core: AST loading, name resolution, pragmas, baselines,
profiles.

The framework half of the port's copy of the project-native
static-analysis suite (the reference's catalog: docs/STATIC_ANALYSIS.md).
Dependency-free by design — stdlib ``ast`` only, no torch and no JAX —
because it runs in tier-1 and must never hinge on a linter version the
container doesn't pin.

Pieces:

- `Finding`: one diagnostic (rule, path, line, message), hashable into a
  stable baseline key that survives unrelated line drift (the key hashes
  the *source line text*, not the line number).
- `ModuleInfo`: a parsed file plus the cross-rule plumbing every rule
  needs — parent links, enclosing-function lookup, and best-effort
  resolution of call names through imports (`from time import sleep`
  still resolves to ``time.sleep``).
- Pragmas: ``# graftlint: disable=<rule>[,<rule>] -- <justification>``
  suppresses findings on its line; ``# graftlint: disable-file=<rule> --
  <justification>`` suppresses for the whole file. The justification is
  REQUIRED and must be non-empty — a suppression is a recorded decision,
  not an escape hatch. Unknown rule names and pragmas that suppress
  nothing are themselves findings (`pragma-hygiene`), so stale
  suppressions rot loudly.
- Baseline: `--write-baseline` snapshots today's unsuppressed findings
  so a NEW rule can land gating only new code while the burn-down file
  shrinks; `--baseline` filters against it and reports stale entries.
- Profiles: which framework's names the rules know. ``torch`` (the
  default) reads the port: ``DL4J_CUDA_*`` knobs, a CUDA graph capture
  as the compiled region (rules/_torch.py). ``jax`` reproduces the
  reference's analyzer exactly: ``DL4J_TPU_*`` knobs, jit/lax bodies
  (rules/_jax.py), donation. Each `ModuleInfo` carries the profile it
  was loaded under; a rule that has no counterpart under a profile says
  why in `Rule.not_applicable` (shown by ``--list-rules``).
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: this repo's root (analysis/ is self-hosted two levels below it) —
#: used to relativize baseline keys so they are checkout-portable
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _portable(path: str) -> str:
    """Repo-relative when under the repo, basename otherwise (temp
    fixtures): the same finding must key identically on every checkout."""
    ap = os.path.abspath(path)
    if ap.startswith(_ROOT + os.sep):
        return os.path.relpath(ap, _ROOT).replace(os.sep, "/")
    return os.path.basename(ap)


PRAGMA_RE = re.compile(
    r"#\s*graftlint:\s*(disable|disable-file)="
    r"(?P<rules>[A-Za-z0-9_,\- ]+?)"
    r"(?:\s+--\s*(?P<why>.*?))?\s*$")

#: rule id for framework-level pragma findings
PRAGMA_RULE = "pragma-hygiene"

#: the rule profiles (module docstring); the first is the default
PROFILES = ("torch", "jax")
DEFAULT_PROFILE = PROFILES[0]


def _check_profile(profile: str) -> None:
    if profile not in PROFILES:
        raise ValueError(f"unknown graftlint profile {profile!r} "
                         f"(one of {', '.join(PROFILES)})")

#: rule id for files the analyzer could not read/parse — a lint gate
#: must never treat an unparseable file as clean
PARSE_RULE = "parse-error"


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str
    col: int = 0

    def key(self, source_line: str, occurrence: int = 0) -> str:
        """Stable baseline key: rule + repo-relative path + the flagged
        line's text (whitespace-normalized) + an occurrence ordinal —
        survives the file growing above it AND the repo living at a
        different checkout path (a committed baseline must match on
        every machine); the ordinal keeps two identical offending lines
        in one file from sharing a key (a NEW duplicate must gate)."""
        text = " ".join(source_line.split())
        h = hashlib.sha1(
            f"{self.rule}|{_portable(self.path)}|{text}|{occurrence}"
            .encode()).hexdigest()
        return h[:16]

    def render(self, root: Optional[str] = None) -> str:
        p = os.path.relpath(self.path, root) if root else self.path
        return f"{p}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass
class Pragma:
    line: int
    file_level: bool
    rules: Tuple[str, ...]
    justification: str
    used: bool = False
    #: a pragma on a comment-only line suppresses the NEXT line, so long
    #: justifications don't force long source lines (the one place the
    #: targeting rule lives is _apply_pragmas)
    own_line: bool = False


class ModuleInfo:
    """One parsed source file + the shared analysis plumbing."""

    def __init__(self, path: str, text: str, tree: ast.Module,
                 profile: str = DEFAULT_PROFILE):
        _check_profile(profile)
        self.profile = profile
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.imports = _import_map(tree)
        self.pragmas = _parse_pragmas(self.lines)

    # -------------------------------------------------------- navigation
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self.parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    # ---------------------------------------------------- name resolution
    def dotted(self, node: ast.AST) -> Optional[str]:
        """`jnp.asarray` -> "jax.numpy.asarray" (through import aliases);
        plain names resolve through `from x import y`. Best-effort: None
        for anything not a Name/Attribute chain."""
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        head = self.imports.get(cur.id, cur.id)
        parts.append(head)
        return ".".join(reversed(parts))

    def call_name(self, call: ast.Call) -> Optional[str]:
        return self.dotted(call.func)

    def source_line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

def _import_map(tree: ast.Module) -> Dict[str, str]:
    """local alias -> full dotted origin. `import jax.numpy as jnp` maps
    jnp -> jax.numpy; `from time import sleep` maps sleep -> time.sleep;
    `from jax import jit as j` maps j -> jax.jit."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _parse_pragmas(lines: Sequence[str]) -> List[Pragma]:
    out = []
    for i, raw in enumerate(lines, 1):
        m = PRAGMA_RE.search(raw)
        if not m:
            continue
        rules = tuple(r.strip() for r in m.group("rules").split(",")
                      if r.strip())
        out.append(Pragma(line=i, file_level=(m.group(1) == "disable-file"),
                          rules=rules,
                          justification=(m.group("why") or "").strip(),
                          own_line=raw.lstrip().startswith("#")))
    return out


# ---------------------------------------------------------------- rules
class Rule:
    """Base class: subclasses set `name` (kebab-case id), `summary`, and
    `historical` (the shipped bug this rule encodes), and implement
    `check(module) -> iterable[Finding]`. `not_applicable` maps a
    profile under which the rule has no counterpart to the reason; the
    runner skips the rule there and ``--list-rules`` says why."""

    name = ""
    summary = ""
    historical = ""
    not_applicable: Dict[str, str] = {}

    def applies(self, profile: str) -> bool:
        return profile not in self.not_applicable

    def check(self, module: ModuleInfo) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, module: ModuleInfo, node: ast.AST, message: str) -> Finding:
        return Finding(rule=self.name, path=module.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0), message=message)


class Project:
    """Everything project-wide rules share for one run: the parsed
    modules plus lazily-built, cached cross-module models (call graph,
    concurrency facts). Built once by `run()` so four rules don't build
    four call graphs."""

    def __init__(self, modules: Sequence[ModuleInfo]):
        self.modules = list(modules)
        self._concurrency = None

    def concurrency(self):
        """The shared ConcurrencyModel (analysis/concurrency.py) —
        imported lazily to keep core.py's import graph acyclic."""
        if self._concurrency is None:
            from deeplearning4j_tpu_torch.analysis.concurrency import (
                ConcurrencyModel,
            )
            self._concurrency = ConcurrencyModel(self.modules)
        return self._concurrency


class ProjectRule(Rule):
    """A rule that needs the WHOLE analyzed tree — the interprocedural
    concurrency family. `check()` is a per-module no-op; the runner
    calls `check_project(project)` once and routes each finding back to
    its module for pragma suppression."""

    def check(self, module: ModuleInfo) -> Iterable[Finding]:
        return ()

    def check_project(self, project: Project
                      ) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


# ---------------------------------------------------------------- runner
def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                out.append(os.path.abspath(p))
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", ".git")]
                for f in sorted(filenames):
                    if f.endswith(".py"):
                        out.append(os.path.abspath(os.path.join(dirpath, f)))
    return sorted(dict.fromkeys(out))


def load_module(path: str, profile: str = DEFAULT_PROFILE
                ) -> Optional[ModuleInfo]:
    try:
        with open(path, encoding="utf-8") as fh:
            text = fh.read()
        return ModuleInfo(path, text, ast.parse(text, filename=path),
                          profile)
    except (OSError, SyntaxError):
        return None


@dataclasses.dataclass
class RunResult:
    findings: List[Finding]            # unsuppressed
    suppressed: List[Finding]          # pragma-silenced
    pragma_findings: List[Finding]     # bad/unused pragmas
    files: int = 0
    #: the Project built for this run (lock-graph export reuses its
    #: already-built concurrency model instead of re-analyzing)
    project: Optional[Project] = None

    @property
    def all_unsuppressed(self) -> List[Finding]:
        return sorted(self.findings + self.pragma_findings,
                      key=lambda f: (f.path, f.line, f.rule))


def run(paths: Sequence[str], rules: Sequence[Rule],
        select: Optional[Set[str]] = None,
        module_findings: Optional[Dict[str, List[Finding]]] = None,
        profile: str = DEFAULT_PROFILE) -> RunResult:
    """Run `rules` over every .py under `paths` under `profile`, applying
    pragma suppression and pragma hygiene checks.

    `module_findings` (path -> raw findings) lets a caller supply the
    per-module rules' output computed elsewhere — the CLI's multiprocess
    pass (deeplearning4j_tpu_torch/tools/graftlint.py) farms exactly that
    part out to workers; project-wide rules, pragmas and parse-error
    reporting always run here (they need every module in one address
    space)."""
    _check_profile(profile)
    active = [r for r in rules if (select is None or r.name in select)
              and r.applies(profile)]
    mod_rules = [r for r in active if not isinstance(r, ProjectRule)]
    proj_rules = [r for r in active if isinstance(r, ProjectRule)]
    known = {r.name for r in rules} | {PRAGMA_RULE, PARSE_RULE}
    res = RunResult([], [], [])
    modules: List[ModuleInfo] = []
    for path in iter_py_files(paths):
        mod = load_module(path, profile)
        if mod is None:
            # unreadable/syntax-broken: surface it — zero findings from
            # a file the analyzer never inspected is not "clean"
            res.findings.append(Finding(
                rule=PARSE_RULE, path=path, line=1,
                message="file could not be read/parsed — the analyzer "
                        "inspected none of it"))
            continue
        modules.append(mod)
    res.files = len(modules)
    raw_by_path: Dict[str, List[Finding]] = {m.path: [] for m in modules}
    if module_findings is not None:
        for path, fs in module_findings.items():
            if path in raw_by_path:
                raw_by_path[path].extend(fs)
    else:
        for mod in modules:
            for rule in mod_rules:
                raw_by_path[mod.path].extend(rule.check(mod))
    project = Project(modules)
    res.project = project       # lock-graph export reuses the build
    for rule in proj_rules:
        for f in rule.check_project(project):
            raw_by_path.setdefault(f.path, []).append(f)
    for mod in modules:
        _apply_pragmas(mod, raw_by_path[mod.path], known, res, select)
    res.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return res


def _apply_pragmas(mod: ModuleInfo, raw: List[Finding], known: Set[str],
                   res: RunResult, select: Optional[Set[str]]) -> None:
    line_pragmas: Dict[int, List[Pragma]] = {}
    file_pragmas: List[Pragma] = []
    for pr in mod.pragmas:
        if pr.file_level:
            file_pragmas.append(pr)
        else:
            target = pr.line + 1 if pr.own_line else pr.line
            line_pragmas.setdefault(target, []).append(pr)
        for rname in pr.rules:
            if rname not in known:
                res.pragma_findings.append(Finding(
                    rule=PRAGMA_RULE, path=mod.path, line=pr.line,
                    message=f"pragma names unknown rule {rname!r}"))
        if not pr.justification:
            res.pragma_findings.append(Finding(
                rule=PRAGMA_RULE, path=mod.path, line=pr.line,
                message="suppression requires a justification: "
                        "`# graftlint: disable=<rule> -- <why>`"))
    for f in raw:
        suppressing = None
        for pr in line_pragmas.get(f.line, []):
            if f.rule in pr.rules:
                suppressing = pr
                break
        if suppressing is None:
            for pr in file_pragmas:
                if f.rule in pr.rules:
                    suppressing = pr
                    break
        if suppressing is not None and suppressing.justification:
            suppressing.used = True
            res.suppressed.append(f)
        else:
            if suppressing is not None:
                suppressing.used = True   # used, but invalid (no why)
            res.findings.append(f)
    # a pragma that suppressed nothing is stale — unless the run was
    # rule-filtered (--select), where "its" rule may simply not have run
    if select is None:
        for pr in mod.pragmas:
            if not pr.used and all(r in known for r in pr.rules):
                res.pragma_findings.append(Finding(
                    rule=PRAGMA_RULE, path=mod.path, line=pr.line,
                    message="pragma suppresses nothing on this line — "
                            "remove it (stale suppressions hide regressions)"))


# -------------------------------------------------------------- baseline
def _keyed(result: RunResult) -> List[Tuple[str, Finding]]:
    """(stable-key, finding) pairs; each file read once. Findings that
    would hash identically (same rule+file+line text) get consecutive
    occurrence ordinals in source order, so duplicates stay distinct."""
    cache: Dict[str, List[str]] = {}
    seen: Dict[Tuple[str, str, str], int] = {}
    out: List[Tuple[str, Finding]] = []
    for f in result.all_unsuppressed:
        if f.path not in cache:
            try:
                with open(f.path, encoding="utf-8") as fh:
                    cache[f.path] = fh.read().splitlines()
            except OSError:
                cache[f.path] = []
        lines = cache[f.path]
        text = lines[f.line - 1] if 0 < f.line <= len(lines) else ""
        ident = (f.rule, f.path, " ".join(text.split()))
        n = seen.get(ident, 0)
        seen[ident] = n + 1
        out.append((f.key(text, occurrence=n), f))
    return out


def write_baseline(path: str, result: RunResult) -> None:
    findings = {k: f.render() for k, f in _keyed(result)}
    data = {"version": 1, "findings": findings}
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=2, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)


def apply_baseline(path: str, result: RunResult
                   ) -> Tuple[List[Finding], List[str]]:
    """Split result against a baseline: returns (new_findings,
    stale_baseline_keys). Baselined findings don't gate; stale keys mean
    the burn-down shrank — rewrite the file to bank the progress."""
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    known = set(data.get("findings", {}))
    keyed = _keyed(result)
    new = [f for k, f in keyed if k not in known]
    stale = sorted(known - {k for k, _ in keyed})
    return new, stale
