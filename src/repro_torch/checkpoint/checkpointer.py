"""Fault-tolerant checkpointing: atomic, asynchronous, restorable.

The reference's layout (``repro.checkpoint.checkpointer``), per step:

    <dir>/step_000000123/
        arrays.npz          every leaf, named by its key path (``['w']##[0]``)
        manifest.json       step, tree structure, extra state (the data
                            cursor), dtypes, the policy artifact trained under
    <dir>/LATEST            atomic pointer file (rename())

Guarantees (``tests/test_torch_checkpoint_ft.py``):
  * a kill between ``save`` calls never corrupts the latest checkpoint
    (write to a temporary directory, atomic rename, ``LATEST`` last);
  * ``keep_k`` garbage collection never deletes the newest durable step;
  * asynchronous mode writes on a thread while the next step runs (the
    arrays are copied to the host on the caller's thread first, so the
    saved state is the one at the call).

numpy has no bfloat16 without ``ml_dtypes``, which the machine with the card
does not have: a bf16 leaf is stored as its ``uint16`` bit pattern, its dtype
recorded in the manifest (``dtypes``), and restored bit for bit.
``restore(shardings=...)`` re-shards onto the current mesh (elastic): each
leaf becomes a DTensor laid out per its ``NamedSharding``.

A sharded tree (DTensor leaves) is saved as its global values: every rank
calls ``save`` and takes part in gathering each leaf, and rank 0 writes.
``restore`` lays a leaf out as its template's DTensor is (or as
``shardings=`` says), so a sharded run resumes from the checkpoint of a
sharded or an unsharded one.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.distributed import sharding as _shd
from repro_torch.optim import tree as T


SEP = "##"

# dtypes numpy cannot hold, stored as their bit patterns
_AS_BITS = {torch.bfloat16: (np.uint16, torch.int16)}


def _key(path) -> str:
    return SEP.join(path)


def _to_numpy(t) -> tuple:
    """(numpy array, dtype name) of one leaf, on the host."""
    if not isinstance(t, torch.Tensor):
        t = torch.as_tensor(t)
    t = _shd.gather(t.detach()).cpu()    # a DTensor's global value
    bits = _AS_BITS.get(t.dtype)
    if bits is not None:
        return t.view(bits[1]).numpy().view(bits[0]), str(t.dtype)
    return t.numpy(), str(t.dtype)


def _flatten(tree):
    flat, dtypes = {}, {}
    for path, leaf in T.leaves_with_path(tree):
        arr, dt = _to_numpy(leaf)
        flat[_key(path)] = arr
        dtypes[_key(path)] = dt
    return flat, dtypes


def _artifact_record(policy_artifact):
    """The active policy's durable identity as the manifest records it."""
    if policy_artifact is None or isinstance(policy_artifact, dict):
        return policy_artifact
    if hasattr(policy_artifact, "to_json") and hasattr(policy_artifact,
                                                       "version"):
        return policy_artifact.to_json()                    # ArtifactRef
    return {"name": policy_artifact.name, "version": None,   # PolicyArtifact
            "digest": policy_artifact.digest}


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


class Checkpointer:
    def __init__(self, directory: str, keep_k: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_k = keep_k
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None,
             block: bool = False, policy_artifact: Optional[Any] = None):
        """``policy_artifact``: the active precision policy's durable
        identity -- an ``ArtifactRef``, a ``PolicyArtifact`` (name + content
        digest recorded) or a plain ``{name, version, digest}`` dict --
        recorded in ``manifest.json`` so a restored run can re-load (and
        hash-verify) the exact policy it was training under."""
        # to the host on the caller's thread; DTensor leaves are gathered,
        # a collective every rank makes, and rank 0 alone writes them
        flat, dtypes = _flatten(tree)
        if _shd.any_dtensor(tree) and _rank() != 0:
            return
        manifest = {
            "step": int(step),
            "treedef": T.structure(tree),
            "extra": extra or {},
            "process_count": 1,
            "policy_artifact": _artifact_record(policy_artifact),
            "dtypes": dtypes,
        }
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, manifest), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, manifest)

    def _write(self, step: int, flat, manifest):
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, f".tmp_{name}_{os.getpid()}")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        latest_tmp = os.path.join(self.dir, ".LATEST_tmp")
        with open(latest_tmp, "w") as f:
            f.write(name)
        os.rename(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in steps[:-self.keep_k] if self.keep_k else []:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---- restore ---------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip().split("_")[-1])

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Any = None):
        """Restore into the structure of ``template``: each leaf gets the
        template leaf's dtype and device (a Python scalar leaf comes back as
        a 0-d tensor on the CPU). ``shardings`` (the template's structure or
        a prefix of it, ``distributed.sharding.NamedSharding`` leaves, or
        ``None`` for a leaf kept as it is) re-shards for the *current* mesh:
        each leaf is laid out per its sharding on that DeviceMesh --
        elastic. Returns ``(tree, manifest)``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        base = os.path.join(self.dir, f"step_{step:09d}")
        with np.load(os.path.join(base, "arrays.npz")) as z:
            data = {k: z[k] for k in z.files}
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})

        def load(path, like):
            key = _key(path)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            saved = dtypes.get(key)
            t = torch.from_numpy(arr)
            for dt, (_, signed) in _AS_BITS.items():
                if saved == str(dt):
                    t = t.view(signed).view(dt)
            if isinstance(like, torch.Tensor):
                t = t.to(device=like.device, dtype=like.dtype)
                if _shd._is_dtensor(like):
                    t = _shd.place_as(t, like)
            return t

        tree = T.unflatten(template, [
            load(path, like) for path, like in T.leaves_with_path(template)
        ])
        if shardings is not None:
            from repro_torch.distributed.sharding import place_tree
            tree = place_tree(tree, shardings)
        return tree, manifest
