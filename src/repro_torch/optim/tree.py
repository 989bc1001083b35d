"""Trees of tensors in the reference's leaf order.

Parameters, optimizer state and gradients are nested dicts and lists of
tensors. JAX flattens a dict in sorted key order; the optimizer sums the
squares of the gradients and the checkpointer names its arrays in that
order, so the port walks trees the same way (``torch.utils._pytree`` keeps
insertion order). ``None`` is an empty subtree, as in JAX: it has no leaf
and maps to ``None``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def leaves_with_path(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple]:
    """``[(path, leaf)]`` of every leaf, in the reference's order; a path is
    the tuple of the reference's key strings (``['w']``, ``[0]``)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, sub in kids:
        out.extend(leaves_with_path(sub, prefix + (key,)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure; a ``None`` there is handed to
    ``fn`` as ``None``). ``None`` subtrees of ``tree`` stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[None if r is None else r[k]
                                     for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *[None if r is None else r[i] for r in rest])
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def structure(tree) -> str:
    """A printable structure, ``*`` for a leaf (the manifest's
    ``treedef``)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def unflatten(like, flat):
    """A tree of ``like``'s structure (its dicts keep their key order) whose
    leaves are ``flat``, taken in the order ``leaves(like)`` lists them."""
    return _unflatten(like, iter(flat))


def _unflatten(t, it):
    # module level, not a closure: a recursive closure is a reference cycle,
    # and it would keep the leaves alive until the garbage collector runs
    if t is None:
        return None
    kids = _children(t)
    if kids is None:
        return next(it)
    if isinstance(t, dict):
        done = {k: _unflatten(t[k], it) for k in sorted(t)}
        return {k: done[k] for k in t}
    return type(t)(_unflatten(v, it) for v in t)


def up_to(like, tree) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``like``, in
    ``leaves(like)``'s order (``None`` where ``tree`` is ``None``)."""
    out: List[Any] = []
    _up_to(like, tree, out)
    return out


def _up_to(a, b, out):
    if a is None:
        return
    kids = _children(a)
    if kids is None:
        out.append(b)
    elif isinstance(a, dict):
        for k in sorted(a):
            _up_to(a[k], None if b is None else b[k], out)
    else:
        for i, v in enumerate(a):
            _up_to(v, None if b is None else b[i], out)
