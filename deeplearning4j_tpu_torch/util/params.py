"""Canonical flat parameter view.

Counterpart of the part of the JAX package's `util/params.py` that the
containers use: the deterministic leaf order (keys that are integers
sorted numerically first, then the others lexicographically), the flat
vector in that order and its inverse, the parameter count, and the
`summary()` table.
"""
from __future__ import annotations

import math

import torch


def _sorted_items(tree: dict):
    def keyfn(k):
        try:
            return (0, int(k), "")
        except (TypeError, ValueError):
            return (1, 0, str(k))
    return sorted(tree.items(), key=lambda kv: keyfn(kv[0]))


def iter_leaves(tree, prefix=()):
    """(path, leaf) pairs in the canonical order."""
    if isinstance(tree, dict):
        for k, v in _sorted_items(tree):
            yield from iter_leaves(v, prefix + (str(k),))
    elif tree is not None:
        yield prefix, tree


def num_params(tree) -> int:
    return sum(math.prod(leaf.shape) for _, leaf in iter_leaves(tree))


def params_to_flat(tree) -> torch.Tensor:
    """The leaves raveled and joined in the canonical order."""
    leaves = [leaf.reshape(-1) for _, leaf in iter_leaves(tree)]
    if not leaves:
        return torch.zeros((0,), dtype=torch.float32)
    return torch.cat(leaves)


def flat_views(flat: torch.Tensor, template):
    """A tree shaped like `template` whose leaves are views of the 1-D
    tensor `flat` in the canonical order (no copy): autograd through the
    views reaches `flat`, as the reference's `jax.value_and_grad` over the
    flat vector does."""
    chunks, offset = {}, 0
    for path, leaf in iter_leaves(template):
        n = math.prod(leaf.shape)
        chunks[path] = flat[offset:offset + n].view(leaf.shape)
        offset += n
    if offset != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} values for "
                         f"{offset} parameters")

    def rebuild(node, path):
        if isinstance(node, dict):
            return {k: rebuild(v, path + (str(k),)) for k, v in node.items()}
        return chunks[path]
    return rebuild(template, ())


def flat_to_params(flat, template):
    """The inverse of `params_to_flat`: a tree shaped, typed and placed
    like `template`, each leaf its own copy."""
    views = flat_views(torch.as_tensor(flat).reshape(-1), template)

    def own(view, leaf):
        if isinstance(leaf, dict):
            return {k: own(view[k], v) for k, v in leaf.items()}
        return view.to(device=leaf.device, dtype=leaf.dtype).clone()
    return own(views, template)


def format_param_table(rows, total: int) -> str:
    """Fixed-width table for summary(); rows[0] is the header; a
    total-parameters footer is appended."""
    widths = [max(len(r[c]) for r in rows) for c in range(len(rows[0]))]
    gap = 2 * (len(widths) - 1)
    lines = ["  ".join(v.ljust(w) for v, w in zip(r, widths)) for r in rows]
    lines.insert(1, "-" * (sum(widths) + gap))
    lines.append(f"total parameters: {total:,}")
    return "\n".join(lines)
