"""Lazy package re-exports (PEP 562).

The port's package `__init__` files export the reference's names without
importing the modules that define them: a name's module is imported on
its first access. So `import deeplearning4j_tpu_torch` imports no
submodule, and a spawned data worker that imports `data.pipeline` does
not pull torch in through `data/__init__`.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Tuple


def lazy_exports(package: str, namespace: dict,
                 exports: Dict[str, str]) -> Tuple[Callable, Callable]:
    """(__getattr__, __dir__) for `package`, whose names in `exports`
    (name -> submodule path relative to the package) resolve on first
    access and are then cached in its `namespace`."""

    def __getattr__(name: str):
        mod = exports.get(name)
        if mod is None:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(f"{package}.{mod}"), name)
        namespace[name] = value
        return value

    def __dir__() -> List[str]:
        return sorted(set(namespace) | set(exports))

    return __getattr__, __dir__
