"""Rule: unlaundered-restore-placement — the sharding-aware variant of
the donated-aliasing shape.

Since the GSPMD ShardingPlan, checkpoint restore paths place
parameters onto explicit mesh shardings. ``jax.device_put`` of a freshly
DESERIALIZED value (``np.load`` npz trees, ``flax.serialization
.from_bytes`` updater state, ``pickle.load``) straight onto a sharding
looks correct — the arrays land where the plan wants them — but on CPU
backends a replicated/single-device placement can be ZERO-COPY, so the
"placed" jax array still aliases numpy-owned heap memory; the first
donating train step after resume then frees memory XLA does not own
(the serde-resume segfault, now wearing a sharding).

The blessed path is ``util/params.own_tree(tree, shardings)`` /
``owned_leaf(leaf, sharding)`` (or any route that copies first:
``jnp.array(..., copy=True)`` then place) — copy into an XLA-owned
buffer, THEN place.

Detection (per function scope, same lightweight taint style as the
donated-aliasing rule): values assigned from deserialization calls are
tainted; simple-name propagation follows ``x = y``; passing through
``own_tree``/``owned_leaf``/``jnp.array(copy=True)`` clears; a
``device_put`` call whose value argument is tainted AND that names an
explicit placement (second positional arg, or a ``device=``/
``sharding=``/``donate=`` keyword) is flagged.

Under the torch profile the placement is a zero-copy tensor view:
``torch.from_numpy``/``torch.as_tensor``/``torch.asarray`` of a restored
array shares its memory on the CPU, so the fit's in-place state writes
(`nn/step_graph.commit`'s copies, the optimizer's ``_foreach`` updates)
write through into the loaded array — into read-only memory when it came
from ``np.frombuffer``. Taint follows the same names plus npz members
(``z["w"]`` of ``with np.load(p) as z``) and views (``.reshape``,
``np.asarray``); a copy clears it (``np.array(a)``, ``.copy()``,
``.astype()``, a ``.clone()`` of the view, ``torch.tensor``).
"""
from __future__ import annotations

import ast
from typing import Iterable, Set

from deeplearning4j_tpu_torch.analysis.core import Finding, ModuleInfo, Rule

_DEVICE_PUT = {"jax.device_put", "device_put"}
_OWNING = {"own_tree", "owned_leaf"}
#: deserialization producers — deliberately NARROWER than the
#: donated-aliasing rule's np.* namespace: plain numpy batch staging may
#: legitimately device_put (batches are never donated); RESTORED state is
#: what reaches donate_argnums.
_TAINT_CALLS = {"numpy.load", "np.load", "pickle.load", "pickle.loads"}
_TAINT_SUFFIX = (".from_bytes",)
#: torch profile: zero-copy tensor views (the sinks), further producers,
#: numpy calls and array methods that keep a view (transport taint) or
#: copy (clear it)
_TORCH_VIEWS = {"torch.from_numpy", "torch.as_tensor", "torch.asarray"}
_TORCH_TAINT_CALLS = _TAINT_CALLS | {"numpy.frombuffer", "np.frombuffer"}
_NP_VIEWS = {"numpy.asarray", "np.asarray", "numpy.ascontiguousarray",
             "np.ascontiguousarray"}
_VIEW_METHODS = {"reshape", "view", "ravel", "squeeze", "transpose"}


def _target_name(t: ast.AST):
    if isinstance(t, ast.Name):
        return t.id
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name):
        return f"{t.value.id}.{t.attr}"
    return None


class UnlaunderedRestorePlacementRule(Rule):
    name = "unlaundered-restore-placement"
    summary = ("restored/deserialized leaves must go through "
               "util/params.own_tree(tree, shardings) (or an explicit "
               "copy) before device_put onto a placement (torch profile: "
               "before a zero-copy torch.from_numpy/as_tensor view)")
    historical = ("checkpoint-restored numpy-aliased params "
                  "device_put onto plan shardings can be zero-copy on CPU "
                  "— the donating post-resume step then corrupts the heap "
                  "(the serde-resume segfault, sharding-aware variant)")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        scopes = [mod.tree] + [n for n in ast.walk(mod.tree)
                               if isinstance(n, (ast.FunctionDef,
                                                 ast.AsyncFunctionDef))]
        for scope in scopes:
            yield from self._scope(mod, scope)

    # ------------------------------------------------------------- taint
    def _scope(self, mod: ModuleInfo, scope: ast.AST) -> Iterable[Finding]:
        tainted: Set[str] = set()
        body = scope.body if hasattr(scope, "body") else []
        for stmt in body:
            yield from self._stmt(mod, stmt, tainted)

    def _stmt(self, mod: ModuleInfo, stmt: ast.AST,
              tainted: Set[str]) -> Iterable[Finding]:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return      # nested scopes visited on their own
        if isinstance(stmt, ast.Assign):
            taints = self._taints(mod, stmt.value, tainted)
            for t in stmt.targets:
                tn = _target_name(t)
                if tn is not None:
                    (tainted.add if taints else tainted.discard)(tn)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)) and \
                mod.profile == "torch":
            # `with np.load(p) as z:` — z's members are the fresh arrays
            for item in stmt.items:
                tn = _target_name(item.optional_vars) \
                    if item.optional_vars is not None else None
                if tn is not None and self._taints(
                        mod, item.context_expr, tainted):
                    tainted.add(tn)
        # check only this statement's OWN expressions — the recursion
        # below visits nested statements exactly once (walking the whole
        # subtree here would double-report a flagged call per enclosing
        # compound statement, the defect class a hardening fixed
        # for blocking-under-lock)
        for expr in self._own_exprs(stmt):
            for node in ast.walk(expr):
                if isinstance(node, ast.Call):
                    yield from self._check_put(mod, node, tainted)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.stmt):
                yield from self._stmt(mod, child, tainted)

    @staticmethod
    def _own_exprs(stmt: ast.AST):
        """The statement's direct expression children (nested statement
        bodies are excluded — the statement recursion covers those)."""
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                yield child
            elif isinstance(child, (ast.withitem, ast.keyword)):
                for sub in ast.iter_child_nodes(child):
                    if isinstance(sub, ast.expr):
                        yield sub

    def _taints(self, mod: ModuleInfo, expr: ast.AST,
                tainted: Set[str]) -> bool:
        if mod.profile == "torch":
            return self._torch_taints(mod, expr, tainted)
        if isinstance(expr, ast.Call):
            name = mod.call_name(expr) or ""
            base = name.split(".")[-1]
            if base in _OWNING:
                return False
            if name in ("jax.numpy.array", "jnp.array"):
                copy_kw = next((kw.value.value for kw in expr.keywords
                                if kw.arg == "copy"
                                and isinstance(kw.value, ast.Constant)),
                               None)
                if copy_kw is not False:      # jnp.array default-copies
                    return False
                return bool(expr.args) and self._taints(mod, expr.args[0],
                                                        tainted)
            if name in ("jax.numpy.asarray", "jnp.asarray"):
                # asarray TRANSPORTS taint (zero-copy on CPU)
                return bool(expr.args) and self._taints(mod, expr.args[0],
                                                        tainted)
            if name in _TAINT_CALLS or name.endswith(_TAINT_SUFFIX):
                return True
            return False
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                          ast.Name):
            return f"{expr.value.id}.{expr.attr}" in tainted
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self._taints(mod, e, tainted) for e in expr.elts)
        return False

    def _torch_taints(self, mod: ModuleInfo, expr: ast.AST,
                      tainted: Set[str]) -> bool:
        """Does `expr` hold (a view of) a restored array, under the torch
        profile?"""
        if isinstance(expr, ast.Call):
            name = mod.call_name(expr) or ""
            if name.split(".")[-1] in _OWNING:
                return False
            if name in _TORCH_TAINT_CALLS or name.endswith(_TAINT_SUFFIX):
                return True
            first = expr.args[0] if expr.args else None
            if name in ("numpy.array", "np.array"):
                copy_kw = next((kw.value.value for kw in expr.keywords
                                if kw.arg == "copy"
                                and isinstance(kw.value, ast.Constant)),
                               None)
                return copy_kw is False and first is not None and \
                    self._torch_taints(mod, first, tainted)
            if name in _NP_VIEWS:
                return first is not None and \
                    self._torch_taints(mod, first, tainted)
            if isinstance(expr.func, ast.Attribute) and \
                    expr.func.attr in _VIEW_METHODS:
                return self._torch_taints(mod, expr.func.value, tainted)
            return False
        if isinstance(expr, ast.Subscript):
            return self._torch_taints(mod, expr.value, tainted)
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                          ast.Name):
            return f"{expr.value.id}.{expr.attr}" in tainted
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self._torch_taints(mod, e, tainted)
                       for e in expr.elts)
        return False

    def _check_view(self, mod: ModuleInfo, call: ast.Call,
                    tainted: Set[str]) -> Iterable[Finding]:
        name = mod.call_name(call)
        if name not in _TORCH_VIEWS or not call.args:
            return
        if any(kw.arg == "copy" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords):
            return
        parent = mod.parent(call)
        if isinstance(parent, ast.Attribute) and parent.attr == "clone":
            return
        if self._torch_taints(mod, call.args[0], tainted):
            yield self.finding(
                mod, call,
                f"zero-copy tensor view ({name}) of a deserialized/"
                "restored array — on the CPU the tensor shares the "
                "array's memory, so the fit's in-place state writes "
                "(step_graph.commit) write through into it (read-only "
                "memory when it came from a buffer); copy first: "
                "np.array(a), .clone() or torch.tensor(a)")

    def _check_put(self, mod: ModuleInfo, call: ast.Call,
                   tainted: Set[str]) -> Iterable[Finding]:
        if mod.profile == "torch":
            yield from self._check_view(mod, call, tainted)
            return
        if mod.call_name(call) not in _DEVICE_PUT:
            return
        explicit_placement = len(call.args) >= 2 or any(
            kw.arg in ("device", "sharding", "donate") for kw in call.keywords)
        if not explicit_placement or not call.args:
            return
        if self._taints(mod, call.args[0], tainted):
            yield self.finding(
                mod, call,
                "device_put of a deserialized/restored value onto an "
                "explicit placement without util/params.own_tree — on CPU "
                "the placed array can alias numpy-owned heap memory, and "
                "the first donating step after resume corrupts it (the "
                "PR-3 serde-resume segfault, sharding-aware variant); "
                "launder with own_tree(tree, shardings)/owned_leaf first")
