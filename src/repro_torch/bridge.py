"""Parameters carried across from the JAX package, through numpy.

The JAX package's parameter trees are NamedTuples (``MLPParams``), tuples of
``(w, b)`` pairs (the Dense leaves of ``MLP``) and dicts.  The functions
here map such trees leaf by leaf, keeping their structure:

* :func:`params_from_numpy` turns numpy leaves (``np.asarray`` of the JAX
  arrays) into tensors, keeping each leaf's dtype unless told otherwise;
* :func:`params_to_numpy` is the inverse;
* :func:`load_jax_checkpoint` reads a ``step_<N>/shard_0.npz`` +
  ``manifest.json`` directory written by either package's
  ``ckpt.CheckpointManager``, whose leaf keys are the flattened tree path
  (:func:`leaf_keys`): ``.field`` for a NamedTuple field, the index for a
  tuple or list entry, the key for a dict entry, joined with ``/`` (e.g.
  ``.w_hidden`` or ``2/0``).

Nothing here imports JAX: the port reads the files, not the library.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

Tree = Any


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def _is_leaf(t) -> bool:
    return isinstance(t, (torch.Tensor, np.ndarray))


def tree_map(fn: Callable[[str, Any], Any], tree: Tree, _path: Tuple[str, ...] = ()) -> Tree:
    """Rebuild ``tree`` with every leaf replaced by ``fn(key, leaf)``, where
    ``key`` is the leaf's checkpoint key (see the module docstring)."""
    if _is_leaf(tree):
        return fn("/".join(_path), tree)
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f), _path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, _path + (str(i),))
                          for i, v in enumerate(tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, _path + (str(k),)) for k, v in tree.items()}
    raise TypeError(f"unsupported parameter tree node {type(tree).__name__} "
                    f"at {'/'.join(_path) or '<root>'}")


def leaf_keys(tree: Tree) -> list[str]:
    """The checkpoint keys of ``tree``'s leaves, in tree order."""
    keys = []
    tree_map(lambda k, leaf: keys.append(k), tree)
    return keys


def by_key(tree: Tree) -> dict:
    """``tree``'s leaves by checkpoint key."""
    out = {}
    tree_map(lambda key, leaf: out.__setitem__(key, leaf), tree)
    return out


def to_device(tree: Tree, device) -> Tree:
    """Every tensor leaf of ``tree`` on ``device``."""
    return tree_map(lambda _, t: torch.as_tensor(t).to(device), tree)


def params_from_numpy(tree: Tree, *, dtype: Optional[torch.dtype] = None,
                      device=None) -> Tree:
    """Numpy leaves -> tensors on ``device`` (the CUDA device by default),
    keeping each leaf's dtype unless ``dtype`` is given.  A NamedTuple with
    the fields of ``MLPParams`` becomes the port's ``MLPParams``."""
    from repro_torch.core.ntp import MLPParams

    device = resolve_device(device)

    def convert(_, leaf):
        return torch.tensor(np.asarray(leaf), device=device, dtype=dtype)

    out = tree_map(convert, tree)
    if _is_namedtuple(out) and out._fields == MLPParams._fields:
        out = MLPParams(*out)
    return out


def params_to_numpy(tree: Tree) -> Tree:
    """Tensor leaves -> numpy arrays (on the host), structure kept."""
    return tree_map(lambda _, t: t.detach().cpu().numpy(), tree)


def load_jax_checkpoint(directory: str, net, step: Optional[int] = None, *,
                        dtype: torch.dtype = torch.float64,
                        device=None) -> Tree:
    """``net``'s parameters from a ``CheckpointManager`` directory, written
    by either package (latest step by default), as tensors of ``dtype`` on
    ``device`` (the CUDA device by default): :meth:`repro_torch.ckpt.
    CheckpointManager.restore` against ``net.init``'s tree.  Raises, naming
    the leaves, when the checkpoint's leaf set or shapes differ from
    ``net``'s."""
    from repro_torch.ckpt import CheckpointManager

    device = resolve_device(device)
    mgr = CheckpointManager(directory)
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory!r}")
    like = net.init(torch.Generator().manual_seed(0), dtype=dtype, device=device)
    params = mgr.restore(step, like)
    got = by_key(params)
    for key, ref in by_key(like).items():
        if got[key].shape != ref.shape:
            raise ValueError(f"checkpoint leaf {key!r} has shape {tuple(got[key].shape)}, "
                             f"the network wants {tuple(ref.shape)}")
    return params
