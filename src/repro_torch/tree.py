"""Nested dict/list/tuple parameter and cache trees: map, flatten, unflatten.

Paths are the reference's checkpoint keys: dict keys and list indices
joined with "/" (``repro/checkpoint/checkpoint.py``), e.g.
``decoder/0/p0/attn/wq``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over ``tree`` and same-shaped ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def flatten_with_paths(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{"a/0/b": leaf, ...}, keys in the tree's own order."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flatten_with_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten_paths(flat: Dict[str, Any]) -> Any:
    """Inverse of ``flatten_with_paths``: a path component that is a
    decimal integer indexes a list, any other a dict."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        node = root
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    return _lists(root)


def _lists(node: Any) -> Any:
    if not isinstance(node, dict):
        return node
    if node and all(k.isdigit() for k in node):
        return [_lists(node[str(i)]) for i in range(len(node))]
    return {k: _lists(v) for k, v in node.items()}
