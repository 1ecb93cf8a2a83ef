"""Checkpoints in the JAX package's on-disk format: a shard file and an atomic manifest.

The port of ``repro.train.checkpoint``, one host.  A checkpoint is
``<dir>/step_<8 digits>/`` holding

* ``shards_host0.npz``: one array a leaf, keyed by its path (dict keys
  and list indices) joined by ``__``;
* ``manifest.json``: step, host count, each leaf's shape and dtype under
  its ``/``-joined path, and the caller's ``extra``.  It is written to a
  temporary name and renamed, so a crash mid-save leaves no manifest,
  and :func:`latest_step` only sees finished checkpoints.

The format is JAX's key for key, so each package restores the other's
checkpoints.  A bf16 leaf is stored as JAX stores it: its raw 2-byte
payload, which the npz holds as the void type ``|V2`` (numpy has no
bf16), with ``"bfloat16"`` in the manifest; :func:`restore` reads it
back by the manifest's dtype, bit for bit.  (JAX's own ``restore``
cannot read such a leaf back.)  A run whose ranks hold blocks of a leaf
(a ``model`` axis, ``train.train_loop.fit``) gathers whole leaves before
:func:`save` and places its blocks again after :func:`restore`, so the
files are the same whatever the mesh.  :class:`AsyncCheckpointer` copies the
tree to host memory on the caller's thread, writes on a thread of its
own and keeps the newest ``keep`` checkpoints.
"""
from __future__ import annotations

import json
import os
import pathlib
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, tree_map_with_path


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _host(leaf):
    """A host copy of a leaf (a copy, so later updates cannot reach it):
    a CPU tensor for a tensor, else a numpy array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(the array the npz stores, the manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return (leaf.contiguous().view(torch.uint16).numpy()
                    .view(np.dtype("V2")), "bfloat16")
        leaf = leaf.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree: Any,
         extra: Optional[Dict] = None, host_id: int = 0) -> pathlib.Path:
    """Synchronous save. Returns the checkpoint directory."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    arrays, meta = {}, {}
    for path, leaf in leaves_with_paths(tree):
        arr, dtype = _to_numpy(leaf)
        key = _key(path)
        arrays[key.replace("/", "__")] = arr
        meta[key] = {"shape": list(arr.shape), "dtype": dtype}
    np.savez(d / f"shards_host{host_id}.npz", **arrays)
    manifest = {"step": step, "n_hosts": 1, "leaves": meta,
                "extra": extra or {}}
    tmp = d / "manifest.json.tmp"
    tmp.write_text(json.dumps(manifest))
    os.replace(tmp, d / "manifest.json")     # atomic publish
    return d


def _steps(ckpt_dir: str):
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return []
    return sorted(int(sub.name.split("_")[1]) for sub in d.iterdir()
                  if sub.name.startswith("step_")
                  and (sub / "manifest.json").exists())


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest step with a published manifest, or None."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, template: Any) -> Tuple[Any, Dict]:
    """(tree, extra) of checkpoint ``step``.  ``template`` gives the tree
    structure, and each leaf goes to the device of the template's leaf
    at its path (the saved dtype is kept; a ``bfloat16`` leaf comes back
    as its bits)."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat: Dict[str, np.ndarray] = {}
    for f in sorted(d.glob("shards_host*.npz")):
        with np.load(f) as z:
            for k in z.files:
                flat[k.replace("__", "/")] = z[k]

    def load(path, tmpl):
        key = _key(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        dev = tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu"
        dtype = manifest["leaves"].get(key, {}).get("dtype")
        return _from_numpy(flat[key], dtype).to(dev)
    return tree_map_with_path(load, template), manifest.get("extra", {})


class AsyncCheckpointer:
    """Overlap checkpoint I/O with training (one save in flight)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Copy ``tree`` to the host now; write it on the save thread."""
        self.wait()
        host_tree = tree_map_with_path(lambda _, x: _host(x), tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except BaseException as e:   # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        """Join the save in flight; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        d = pathlib.Path(self.ckpt_dir)
        for s in _steps(self.ckpt_dir)[:-self.keep]:
            sub = d / f"step_{s:08d}"
            for f in sub.iterdir():
                f.unlink()
            sub.rmdir()
