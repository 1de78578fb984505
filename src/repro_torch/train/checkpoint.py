"""Fault-tolerant checkpointing: atomic, keep-k (counterpart of
``repro/train/checkpoint.py``), writing the reference's files.

Layout per step:  <dir>/step_<n>.tmp/  ->  (atomic rename)  ->  <dir>/step_<n>/
    manifest.json          {step, leaves: [{path, file, shape, dtype}], extra}
    <leaf-path>.npy        one file per leaf of the tree (numpy, little-endian)

The tree is the reference's: nested dicts and lists (``{"params": ...,
"opt": ...}`` with both in ``models.convert.reference_tree``'s layout),
whose leaves are torch tensors or numpy arrays.  A crash mid-write leaves
only a ``.tmp`` directory, which is never restored; ``restore`` picks the
newest complete step.  With the counter-based data pipeline and the step in
the manifest, a restart continues bit for bit.

bfloat16 leaves are written as the reference writes them (the ``ml_dtypes``
array ``np.save`` gets there): raw 2-byte values under the npy descr
``'<V2'``, the manifest's dtype ``"bfloat16"``.  Numpy alone reads such a
file as ``|V2`` void values, so ``restore`` takes each leaf's dtype from the
manifest: ``"bfloat16"`` comes back as ``torch.bfloat16`` (the reference's
``restore`` cannot read these leaves back: ``jnp.asarray`` refuses ``|V2``).
Nothing here needs ``ml_dtypes``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.convert import listify, to_numpy


def _leaf_paths(tree) -> list:
    """``(path, leaf)`` pairs in the reference's order: dict keys sorted,
    lists in order."""
    paths = []

    def rec(path, node):
        if isinstance(node, dict):
            for k in sorted(node):
                rec(path + (str(k),), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(path + (str(i),), v)
        else:
            paths.append((path, node))
    rec((), tree)
    return paths


def _set_path(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node[int(p)] if isinstance(node, (list, tuple)) else node[p]
    last = path[-1]
    if isinstance(node, (list, tuple)):
        node[int(last)] = value
    else:
        node[last] = value


def _host(leaf) -> Tuple[np.ndarray, str]:
    """(the array to write, the manifest's dtype); bfloat16 as its raw bits."""
    arr = to_numpy(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
    arr = np.require(arr, requirements="C")            # (0-d arrays stay 0-d)
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        return arr.view(np.int16), "bfloat16"
    return arr, str(arr.dtype)


def _write_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    with open(path, "wb") as f:
        np.save(f, arr)
    if dtype == "bfloat16":
        # The bits were saved as '<i2'; '<V2' has its length, so the
        # header's padding stays and the header is patched in place.
        with open(path, "r+b") as f:
            head = f.read(4096)
            end = head.index(b"\n")
            f.seek(0)
            f.write(head[:end].replace(b"'descr': '<i2'", b"'descr': '<V2'", 1))


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = arr if arr.flags.c_contiguous else arr.copy()        # (0-d arrays stay 0-d)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _skeleton(node):
    if isinstance(node, dict):
        return {k: _skeleton(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_skeleton(v) for v in node]
    return None


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3

    def __post_init__(self):
        Path(self.directory).mkdir(parents=True, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        final = Path(self.directory) / f"step_{step:08d}"
        tmp = Path(str(final) + ".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": [], "extra": extra or {}}
        for path, leaf in _leaf_paths(tree):
            arr, dtype = _host(leaf)
            name = "__".join(path) or "root"
            _write_npy(tmp / f"{name}.npy", arr, dtype)
            manifest["leaves"].append({
                "path": list(path), "file": f"{name}.npy",
                "shape": list(arr.shape), "dtype": dtype})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)                     # atomic commit
        self._gc()
        return str(final)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(Path(self.directory) / f"step_{s:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list:
        out = []
        for p in Path(self.directory).iterdir():
            if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp"):
                if (p / "manifest.json").exists():    # complete checkpoints only
                    out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any = None, step: Optional[int] = None, device=None):
        """Restore into the structure of ``template`` (dicts and lists; when
        None, a numeric path part is a list index) as torch tensors on
        ``device`` (the host when None), each leaf in its manifest dtype.
        Returns (tree, manifest)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = Path(self.directory) / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        dev = None if device is None else resolve_device(device)
        out = _skeleton(template) if template is not None else {}
        for entry in manifest["leaves"]:
            val = _tensor(np.load(d / entry["file"]), entry["dtype"])
            if dev is not None:
                val = val.to(dev)
            path = tuple(entry["path"])
            if template is None:
                node = out
                for p in path[:-1]:
                    node = node.setdefault(p, {})
                node[path[-1]] = val
            else:
                _set_path(out, path, val)
        return (listify(out) if template is None else out), manifest
