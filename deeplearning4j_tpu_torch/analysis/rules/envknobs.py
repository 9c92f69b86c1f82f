"""Rule: env-knob-contract — every ``DL4J_CUDA_*`` knob (jax profile:
``DL4J_TPU_*``) goes through util/env.py.

The contract (util/env.py docstring): kill switches are ``=="0"``-ONLY-
disables, opt-ins ``=="1"``-only-enables, ``""`` is unset. Three review
rounds each re-fixed scattered hand-rolled reads that got one of those wrong
(``!= '1'`` turning ``""`` into a disable; ``== "1"`` turning ``"true"``
into one; ``int('')`` crashing a fit). After the migration the
accessors are the only reader — this rule locks the door:

- any ``os.environ.get/[]``, ``os.getenv`` read of a literal
  ``DL4J_CUDA_*`` (``DL4J_TPU_*``) name is flagged (writes — ``os.environ[k] = v``,
  ``setdefault`` used to seed child processes, ``del`` — are fine);
- comparing an accessor result against ``"0"``/``"1"`` re-implements
  flag truthiness by hand and is flagged too: boolean knobs use
  `env_flag`.

The port's accessors (`deeplearning4j_tpu_torch/util/env.py`: env_raw,
env_str, env_int, env_float, env_flag) keep the same contract for its
``DL4J_CUDA_*`` knobs; the profile only picks the prefix.
"""
from __future__ import annotations

import ast
from typing import Iterable, Optional

from deeplearning4j_tpu_torch.analysis.core import Finding, ModuleInfo, Rule

_READ_CALLS = {"os.environ.get", "environ.get", "os.getenv", "getenv",
               "os.environ.setdefault", "environ.setdefault"}
_ACCESSORS = {"env_str", "env_raw", "env_int", "env_float"}


#: the knob prefix each profile checks
_PREFIX = {"torch": "DL4J_CUDA_", "jax": "DL4J_TPU_"}


def _literal_knob(mod: ModuleInfo, node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith(_PREFIX[mod.profile]):
        return node.value
    return None


class EnvKnobContractRule(Rule):
    name = "env-knob-contract"
    summary = ("DL4J_CUDA_* reads (jax profile: DL4J_TPU_*) must go "
               "through util/env.py typed accessors (the "
               "=='0'-only-disables contract)")
    historical = ("three rounds each re-fixed a hand-rolled read: != '1' "
                  "made '' disable a default-on feature; == '1' made "
                  "'true' disable one; int('') crashed the fit")

    def check(self, mod: ModuleInfo) -> Iterable[Finding]:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                yield from self._check_call(mod, node)
            elif isinstance(node, ast.Subscript) and isinstance(
                    node.ctx, ast.Load):
                if mod.dotted(node.value) in ("os.environ", "environ"):
                    knob = _literal_knob(mod, node.slice)
                    if knob:
                        yield self.finding(
                            mod, node,
                            f"direct os.environ[{knob!r}] read — use the "
                            "util/env.py typed accessor (env_flag/env_int/"
                            "env_str) so the knob contract can't drift")
            elif isinstance(node, ast.Compare):
                yield from self._check_handrolled_flag(mod, node)

    def _check_call(self, mod: ModuleInfo, call: ast.Call
                    ) -> Iterable[Finding]:
        name = mod.call_name(call)
        if name not in _READ_CALLS or not call.args:
            return
        knob = _literal_knob(mod, call.args[0])
        if knob is None:
            return
        if name.endswith(".setdefault"):
            # seeding a default for CHILD processes is a write — but the
            # return value being USED means it doubles as a read
            parent = mod.parent(call)
            if isinstance(parent, ast.Expr):
                return
            yield self.finding(
                mod, call,
                f"os.environ.setdefault({knob!r}) used as a READ — route "
                "the read through util/env.py and keep setdefault for "
                "child-process seeding only")
            return
        yield self.finding(
            mod, call,
            f"raw environment read of {knob!r} — use util/env.py "
            "(env_flag honors the =='0'-only-disables contract; "
            "env_int/env_str treat '' as unset)")

    def _check_handrolled_flag(self, mod: ModuleInfo, cmp: ast.Compare
                               ) -> Iterable[Finding]:
        """`env_str("DL4J_CUDA_X") == "1"` — hand-rolled truthiness on an
        accessor result. (Raw-read comparisons are already flagged by
        the read check.)"""
        sides = [cmp.left] + list(cmp.comparators)
        call = next((s for s in sides if isinstance(s, ast.Call)
                     and (mod.call_name(s) or "").split(".")[-1]
                     in _ACCESSORS), None)
        if call is None or not call.args:
            return
        knob = _literal_knob(mod, call.args[0])
        if knob is None:
            return
        lit = next((s for s in sides if isinstance(s, ast.Constant)
                    and s.value in ("0", "1")), None)
        if lit is not None:
            yield self.finding(
                mod, cmp,
                f"hand-rolled flag truthiness on {knob!r} — boolean "
                "knobs use env_flag(name, default=...) so the "
                "=='0'-only-disables contract is applied in one place")
