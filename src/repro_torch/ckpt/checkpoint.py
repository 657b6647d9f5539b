"""Fault-tolerant checkpointing: async, atomic, crash-only restore.

The port of ``repro.ckpt.checkpoint``, with its API and its files. Layout
(one directory per step):
    <root>/step_000000123.tmp/...   during write
    <root>/step_000000123/          after the atomic rename
        manifest.json               step, config hash, mesh shape, tree
                                    def, dtypes, shapes
        arrays.npz                  the flattened leaves, ``leaf_i``

Crash-only: a checkpoint either fully exists (the rename is atomic on a
POSIX filesystem) or is garbage-collected at the next start; the train
loop restores from the newest complete step.

Async: ``save()`` copies the state to host numpy (the only synchronous
part, the reference's ``device_get``), then a daemon thread writes it
while training goes on; at most one write is in flight. ``wait()`` drains
it.

Trees are nested dicts (keys in sorted order) and lists of tensors,
flattened in the order in which JAX flattens the same structures, so
that both packages read each other's files. A train state goes through
``train.steps.state_leaves`` / ``state_from_leaves``, whose order is
that of the reference's ``TrainState``.

bf16 leaves are written as the reference writes them: 2-byte records
(numpy has no bfloat16; the file's dtype is ``|V2``) and ``"bfloat16"``
in the manifest's ``dtypes``. ``restore`` reads the manifest's type and
reinterprets the bits, where the reference's own restore of such a file
raises (ROADMAP, reference baseline).

Meshes: a leaf that is a DTensor is saved as its full host view
(``full_tensor``, a collective every rank of its mesh joins; rank 0
alone writes the files), and ``save`` records the mesh's shape.
``restore(shardings=..., mesh=...)`` reads each leaf as its full host
view and ``distribute_tensor``s it onto the new mesh's placements, as
the reference ``device_put``s onto its shardings, so a checkpoint saved
on one mesh restores onto any other (elastic restart).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

__all__ = ["CheckpointManager"]

_BF16 = "bfloat16"


def _flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any], str]:
    """(leaves, rebuild(leaves) -> tree, the structure as JAX prints a
    treedef's body)."""
    if not isinstance(tree, (dict, list)):
        return [tree], lambda leaves: leaves[0], "*"
    is_dict = isinstance(tree, dict)
    keys = sorted(tree) if is_dict else range(len(tree))
    parts = [_flatten(tree[k]) for k in keys]

    def rebuild(leaves):
        out, i = [], 0
        for flat, sub, _ in parts:
            out.append(sub(leaves[i:i + len(flat)]))
            i += len(flat)
        return dict(zip(keys, out)) if is_dict else out

    if is_dict:
        desc = ", ".join(f"{k!r}: {p[2]}" for k, p in zip(keys, parts))
        desc = "{" + desc + "}"
    else:
        desc = "[" + ", ".join(p[2] for p in parts) + "]"
    return [x for p in parts for x in p[0]], rebuild, desc


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of one leaf (never a view of a tensor that training
    updates in place); bf16 as 2-byte records. A DTensor is gathered to
    its full view first."""
    if isinstance(t, DTensor):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_host(a: np.ndarray, dtype: str, like: torch.Tensor,
               placements=None, mesh=None) -> torch.Tensor:
    """A leaf of the manifest's ``dtype`` on the device of ``like``; with
    ``placements``, a DTensor on ``mesh``."""
    if dtype == _BF16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if placements is None:
        return t.to(like.device)
    t = t.to(torch.device(mesh.device_type, torch.cuda.current_device())
             if mesh.device_type == "cuda" else "cpu")
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _is_writer() -> bool:
    """Rank 0 writes a checkpoint; every rank snapshots (DTensor leaves
    gather collectively)."""
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._pending: Optional[threading.Thread] = None
        self._gc_incomplete()

    # ------------------------------------------------------------- naming --
    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:09d}")

    def _gc_incomplete(self) -> None:
        for name in os.listdir(self.root):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.root, name,
                                               "manifest.json")):
                    steps.append(int(name[5:]))
        return max(steps) if steps else None

    # --------------------------------------------------------------- save --
    def _snapshot(self, leaves: List[torch.Tensor]) -> List[np.ndarray]:
        """The synchronous part of ``save``: every leaf copied to host."""
        return [_to_host(x) for x in leaves]

    def save(self, step: int, state: Any, *, config_hash: str = "",
             mesh_shape: Optional[Dict[str, int]] = None,
             blocking: bool = False) -> None:
        """Snapshot to host, then serialise in a daemon thread."""
        flat, _, desc = _flatten(state)
        host = self._snapshot(flat)
        if not _is_writer():
            return
        manifest = {
            "step": step,
            "config_hash": config_hash,
            "mesh_shape": mesh_shape or {},
            "num_leaves": len(host),
            "treedef": f"PyTreeDef({desc})",
            "dtypes": [_BF16 if x.dtype == torch.bfloat16 else str(a.dtype)
                       for a, x in zip(host, flat)],
            "shapes": [list(a.shape) for a in host],
        }
        self.wait()                        # at most one in-flight write
        t = threading.Thread(target=self._write, args=(step, host, manifest),
                             daemon=True)
        with self._lock:
            self._pending = t
        t.start()
        if blocking:
            self.wait()

    def _write(self, step: int, host: List[np.ndarray],
               manifest: Dict[str, Any]) -> None:
        tmp = self._dir(step) + ".tmp"
        final = self._dir(step)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": a for i, a in enumerate(host)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)              # atomic commit
        self._retain()

    def wait(self) -> None:
        with self._lock:
            t = self._pending
        if t is not None:
            t.join()
            with self._lock:
                self._pending = None

    def _retain(self) -> None:
        steps = sorted(
            int(n[5:]) for n in os.listdir(self.root)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)

    # ------------------------------------------------------------- restore --
    def restore(self, like: Any, *, step: Optional[int] = None,
                shardings: Optional[Any] = None, mesh=None,
                expect_config_hash: str = "") -> Tuple[Any, int]:
        """Load into the structure of ``like``, each leaf of the type the
        manifest names: on the device of ``like``'s leaf, or, with
        ``shardings`` (placements in ``like``'s structure, e.g.
        ``state_leaves(state_shardings(cfg, mesh))``), a DTensor on
        ``mesh``. Returns (state, step)."""
        if shardings is not None and mesh is None:
            raise ValueError("restore(shardings=...) needs the mesh they "
                             "place the leaves on")
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if expect_config_hash and manifest["config_hash"]:
            if manifest["config_hash"] != expect_config_hash:
                raise AssertionError("checkpoint/config mismatch")
        flat_like, rebuild, _ = _flatten(like)
        if manifest["num_leaves"] != len(flat_like):
            raise AssertionError((manifest["num_leaves"], len(flat_like)))
        flat_sh = (_flatten(shardings)[0] if shardings is not None
                   else [None] * len(flat_like))
        if len(flat_sh) != len(flat_like):
            raise AssertionError((len(flat_sh), len(flat_like)))
        with np.load(os.path.join(d, "arrays.npz")) as npz:
            leaves = [_from_host(npz[f"leaf_{i}"], manifest["dtypes"][i], x,
                                 sh, mesh)
                      for i, (x, sh) in enumerate(zip(flat_like, flat_sh))]
        return rebuild(leaves), step

    @staticmethod
    def config_hash(obj: Any) -> str:
        """A short hash of a config: of ``ModelConfig.reference_dict``
        for a model config (the reference's hash where both packages have
        the config), else of the dataclass's or object's JSON."""
        if hasattr(obj, "reference_dict"):
            obj = obj.reference_dict()
        elif dataclasses.is_dataclass(obj):
            obj = dataclasses.asdict(obj)
        blob = json.dumps(obj, sort_keys=True, default=str)
        return hashlib.sha1(blob.encode()).hexdigest()[:16]
