"""Checkpointing: atomic, async, elastic, in the JAX package's format.

A checkpoint is a directory ``step_<N:010d>/`` holding ``shard_0.npz`` (one
array per leaf, keyed by the leaf's path as :func:`repro_torch.bridge.
leaf_keys` spells it) and ``manifest.json`` (``step``, ``time``, the
sorted ``leaves``, ``n_shards``).  Either package reads what the other
writes:

* writes go to ``step_<N>.tmp`` and are renamed into place, so a crashed
  writer never corrupts the latest checkpoint; ``keep`` bounds how many
  stay, and ``step_<N>.tmp`` directories untouched for ``stale_tmp_age_s``
  are swept when a manager opens the directory;
* ``save(blocking=False)`` copies every leaf to the host before it returns
  (the caller may then overwrite its tensors) and leaves the file writing
  to a thread; :meth:`CheckpointManager.wait` joins it;
* restore is elastic: each leaf is cast to the dtype of the matching leaf
  of ``like`` and placed on that leaf's device, or, given ``shardings``
  (a tree of ``(mesh, placements)`` pairs, ``launch.sharding.Sharding``),
  distributed as a DTensor onto that mesh, which may differ from the
  writer's;
* a tree holding DTensors is saved as full tensors: every rank takes part
  in gathering them (``full_tensor``), rank 0 writes, and a blocking save
  returns on every rank once the files are in place.

numpy has no bfloat16 here: a bfloat16 leaf is written widened to float32
(exact), and ``restore`` casts it back through ``like``.  The JAX package
writes bfloat16 as 2-byte void records (``|V2``), which are read as its
bits.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import by_key, leaf_keys, tree_map


def _host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (the full tensor of a DTensor) that shares no
    storage with it."""
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        t = t.full_tensor()
    dtype = torch.float32 if t.dtype == torch.bfloat16 else t.dtype
    return t.detach().to("cpu", dtype, copy=True).numpy()


def _distributed(tree) -> bool:
    """Whether ``tree`` holds a DTensor (its save is collective)."""
    from torch.distributed.tensor import DTensor
    return any(isinstance(leaf, DTensor) for leaf in by_key(tree).values())


def _placed(t: torch.Tensor, ref: torch.Tensor, sharding) -> torch.Tensor:
    """``t`` in ``ref``'s dtype, distributed by ``sharding`` (a ``(mesh,
    placements)`` pair), else on ``ref``'s device."""
    from torch.distributed.tensor import distribute_tensor
    if sharding is None:
        return t.to(device=ref.device, dtype=ref.dtype)
    mesh, placements = sharding
    return distribute_tensor(t.to(device=mesh.device_type, dtype=ref.dtype), mesh,
                             tuple(placements))


def _pairs(tree, other) -> list:
    """``other``'s leaves in ``tree``'s leaf order (``other`` has ``tree``'s
    structure; its leaves may be any object)."""
    if isinstance(tree, torch.Tensor):
        return [other]
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _pairs(v, other[k])]
    return [x for v, o in zip(tree, other) for x in _pairs(v, o)]


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # the JAX package's bfloat16
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    """Numbered checkpoints of a tree of tensors under ``directory`` (see
    the module docstring).  It has no device of its own: ``restore`` puts
    each leaf where the matching leaf of ``like`` lives."""

    def __init__(self, directory: str, keep: int = 3,
                 stale_tmp_age_s: float = 3600.0):
        self.dir = directory
        self.keep = keep
        self.stale_tmp_age_s = stale_tmp_age_s
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._sweep_stale_tmp()

    def _sweep_stale_tmp(self) -> None:
        """Remove ``step_<N>.tmp`` left by a crashed writer.  Only
        directories untouched for ``stale_tmp_age_s`` go: another process
        may be writing into this directory, and a live writer's tmp
        directory has a fresh mtime."""
        now = time.time()
        for name in os.listdir(self.dir):
            if not (name.startswith("step_") and name.endswith(".tmp")):
                continue
            path = os.path.join(self.dir, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue                 # raced with its writer's rename
            if age >= self.stale_tmp_age_s:
                shutil.rmtree(path, ignore_errors=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Write ``tree`` (a tree of tensors) as step ``step``.  The copy to
        the host is done when this returns; with ``blocking=False`` a
        thread writes the files (one at a time: the previous save is
        waited for first)."""
        host_arrays = {key: _host(leaf) for key, leaf in by_key(tree).items()}
        collective = _distributed(tree)
        if collective and dist.get_rank() != 0:
            if blocking:
                dist.barrier()
            return
        if blocking:
            self._write(step, host_arrays)
            if collective:
                dist.barrier()
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host_arrays), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, arrays: Dict[str, np.ndarray]) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):          # a crashed writer's leftovers for this
            shutil.rmtree(tmp)           # step: cleared however fresh, so no
        os.makedirs(tmp)                 # stray file reaches `final`
        np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
        manifest = {"step": step, "time": time.time(),
                    "leaves": sorted(arrays), "n_shards": 1}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        ckpts = self.all_steps()
        for step in ckpts[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{step:010d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @staticmethod
    def _check_leaves(step: int, path: str, stored: set, wanted: set) -> None:
        """Fail when the checkpoint's leaf set and ``like``'s differ, naming
        the leaves (the manifest decides when present; the shard's keys
        otherwise)."""
        manifest_path = os.path.join(path, "manifest.json")
        if os.path.exists(manifest_path):
            with open(manifest_path) as f:
                stored = set(json.load(f).get("leaves", stored))
        missing = sorted(wanted - stored)   # in `like`, absent from the checkpoint
        extra = sorted(stored - wanted)     # in the checkpoint, absent from `like`
        if missing or extra:
            raise ValueError(
                f"checkpoint step {step} does not match the `like` tree:\n"
                f"  leaves missing from the checkpoint: {missing or 'none'}\n"
                f"  checkpoint leaves absent from `like`: {extra or 'none'}\n"
                f"(checkpoint: {path})")

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """``like``'s tree with each leaf read from step ``step``, cast to
        the dtype of ``like``'s leaf and on that leaf's device (the dtype
        and the device may differ from the writer's); with ``shardings``
        (``like``'s structure, a ``(mesh, placements)`` pair a leaf) each
        leaf is a DTensor on its mesh (elastic: the target mesh may differ
        from the writer's)."""
        path = os.path.join(self.dir, f"step_{step:010d}")
        with np.load(os.path.join(path, "shard_0.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        keys = leaf_keys(like)
        self._check_leaves(step, path, set(arrays), set(keys))
        where = dict(zip(keys, _pairs(like, shardings) if shardings is not None
                         else [None] * len(keys)))
        return tree_map(lambda key, ref: _placed(_tensor(arrays[key]), ref, where[key]), like)
