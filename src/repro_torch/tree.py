"""Nested parameter trees of the port: dicts, tuples, lists and NamedTuples
of tensors, walked in the JAX package's leaf order.

`jax.tree.leaves` visits a dict's keys sorted, a tuple or list by index
and a NamedTuple by field; `jax.tree_util.keystr` names a leaf by its path
as "[0]['layers']['wq']" or "[1].m['embed']". The optimizer sums its
global norm in that order and the checkpoint writes its manifest in that
form, so that both agree with the JAX package's.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) of every leaf, in the JAX package's order.
    None is an empty subtree, as in JAX."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten_with_paths(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """`like`'s structure with its leaves replaced, in order."""
    it = iter(new_leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}            # the caller's key order
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and the same-structured `rest`."""
    cols = [leaves(t) for t in (tree,) + rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def spec_map(fn: Callable, specs: Any, *trees: Any) -> Any:
    """fn(spec, leaf, ...) over a tree of partition specs and trees of
    the same structure. A spec (`parallel.sharding.P`) is a tuple, so
    it is the leaf here where a generic walk would descend into it."""
    from repro_torch.parallel.sharding import P
    if isinstance(specs, P):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: spec_map(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if _is_namedtuple(specs) or isinstance(specs, (tuple, list)):
        out = [spec_map(fn, v, *(t[i] for t in trees))
               for i, v in enumerate(specs)]
        return type(specs)(*out) if _is_namedtuple(specs) else type(specs)(out)
    raise TypeError(f"not a spec tree node: {specs!r}")


def spec_leaves(specs: Any) -> list:
    """The specs of a spec tree in the JAX package's leaf order (that of
    `leaves` over the tree they describe)."""
    out = []

    def walk(t, path=""):
        from repro_torch.parallel.sharding import P
        if isinstance(t, P):
            out.append((path, t))
        elif isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{path}[{k!r}]")
        elif _is_namedtuple(t):
            for f in t._fields:
                walk(getattr(t, f), f"{path}.{f}")
        else:
            for i, v in enumerate(t):
                walk(v, f"{path}[{i}]")

    walk(specs)
    return [spec for _, spec in out]

