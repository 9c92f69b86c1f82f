"""Run the JAX package's own test cases against the port.

The reference's fleet, router and rollout tests are framework-neutral:
they drive the control plane with fake clocks, fake replicas and fake
transports. `port_cases` compiles a reference test file with every
``deeplearning4j_tpu`` import pointed at ``deeplearning4j_tpu_torch``
(and the ``DL4J_TPU_`` knobs at ``DL4J_CUDA_``), keeps the imports, the
helpers and the chosen test functions, and returns the compiled module;
`run_case` calls one of its tests with pytest's fixtures. Cases marked
``slow`` in the reference are left out (the port's drills have their own
slow tests).
"""
import ast
import inspect
import pathlib
import sys
import types

REPO = pathlib.Path(__file__).resolve().parent.parent

SUBS = (("deeplearning4j_tpu.", "deeplearning4j_tpu_torch."),
        ("from deeplearning4j_tpu import", "from deeplearning4j_tpu_torch import"),
        ("DL4J_TPU_", "DL4J_CUDA_"))

#: import roots a ported case may keep; anything else at module level
#: (a tools/ module put on sys.path, another test file) is dropped
_ROOTS = {"deeplearning4j_tpu_torch", "numpy", "pytest", "json", "os",
          "random", "threading", "time", "urllib", "hashlib", "subprocess",
          "sys", "io", "queue", "collections", "typing", "zipfile",
          "struct", "logging", "dataclasses", "pickle", "textwrap"}


def _root(node) -> str:
    if isinstance(node, ast.ImportFrom):
        return (node.module or "").split(".")[0]
    return node.names[0].name.split(".")[0]


def _slow(node) -> bool:
    return any("slow" in ast.unparse(d) for d in node.decorator_list)


def port_cases(relpath: str, names=None, extra_subs=(), module_name=None):
    """Compile reference test file `relpath` against the port. `names`:
    the top-level functions and classes to keep (default: all); imports
    of the kept roots always stay. Registered in sys.modules as
    `module_name` when given (so another ported file can import its
    helpers)."""
    text = (REPO / relpath).read_text()
    for a, b in SUBS + tuple(extra_subs):
        text = text.replace(a, b)
    tree = ast.parse(text)
    body = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            if _root(node) in _ROOTS:
                body.append(node)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if (names is None or node.name in names) and not (
                    isinstance(node, ast.FunctionDef) and _slow(node)):
                body.append(node)
        elif isinstance(node, ast.Assign) and names is None:
            body.append(node)
    mod = types.ModuleType(module_name or f"port_of_{pathlib.Path(relpath).stem}")
    mod.__file__ = str(REPO / relpath)
    if module_name:
        sys.modules[module_name] = mod
    exec(compile(ast.Module(body=body, type_ignores=[]), str(REPO / relpath),
                 "exec"), mod.__dict__)
    return mod


def case_names(mod) -> list:
    return sorted(n for n, v in vars(mod).items()
                  if n.startswith("test_") and inspect.isfunction(v))


def run_case(mod, name: str, request):
    fn = getattr(mod, name)
    kwargs = {p: request.getfixturevalue(p)
              for p in inspect.signature(fn).parameters}
    fn(**kwargs)
