"""Parameter trees as the JAX package's ``jax.tree_util`` sees them.

The port's parameter trees are NamedTuples (``MLPParams``), tuples and
lists (the module graphs' layouts) and dicts (``SelfAttention``'s
projections), with tensors at the leaves.  The optimizers need them leaf by
leaf (Adam) and as one flat vector (L-BFGS).  Leaf order follows
``jax.tree_util``: NamedTuple fields and sequence entries in order, dict
entries by **sorted** key, so :func:`ravel` lays a tree out exactly as the
reference's ``jax.flatten_util.ravel_pytree`` does and the two optimizers'
histories can be compared entry by entry.

:func:`bit_equal` is the port's one test of bit identity.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

Tree = Any


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of ``tree`` in ``jax.tree_util`` order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in leaves(sub)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    raise TypeError(f"unsupported parameter tree node {type(tree).__name__}")


def unflatten(like: Tree, new: List[torch.Tensor]) -> Tree:
    """``like``'s structure with its leaves replaced, in order, by ``new``."""
    it = iter(new)

    def build(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        raise TypeError(f"unsupported parameter tree node {type(t).__name__}")

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable[..., torch.Tensor], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` applied leaf by leaf across trees of one structure."""
    cols = [leaves(tree)] + [leaves(r) for r in rest]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])


def ravel(tree: Tree) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Tree]]:
    """(flat vector, unravel) in ``ravel_pytree`` layout: the leaves'
    row-major entries concatenated in leaf order."""
    ls = leaves(tree)
    shapes = [leaf.shape for leaf in ls]
    sizes = [leaf.numel() for leaf in ls]
    flat = torch.cat([leaf.reshape(-1) for leaf in ls]) if ls else torch.zeros(0)

    def unravel(vec: torch.Tensor) -> Tree:
        parts = torch.split(vec, sizes)
        return unflatten(tree, [p.reshape(s) for p, s in zip(parts, shapes)])

    return flat, unravel


def num_params(tree: Tree) -> int:
    return sum(leaf.numel() for leaf in leaves(tree))


# integer types of each element width: comparing these views compares bits
_INT_VIEWS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def bit_equal(a: Tree, b: Tree) -> bool:
    """Whether two tensors (or two trees of them, leaf by leaf) hold the same
    bits: one dtype, one shape, equal integer views.  ``torch.equal``
    compares values, so it counts -0.0 equal to +0.0 (and a NaN unequal to
    itself): it cannot say that data moved unchanged."""
    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb):
        return False
    for x, y in zip(la, lb):
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        view = _INT_VIEWS[x.element_size()]
        if not torch.equal(x.view(view), y.to(x.device).view(view)):
            return False
    return True
