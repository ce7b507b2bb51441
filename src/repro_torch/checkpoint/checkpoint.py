"""Crash-safe, integrity-checked, async checkpoints of the port
(counterpart of ``repro.checkpoint.checkpoint``), in the reference's
on-disk layout, byte for byte::

    <dir>/step_000000123/
        manifest.json        # step; leaves[path] = {file, shape, dtype, crc32}
        leaf_00000.npy ...   # one file a leaf, numbered in sorted path order
        _COMMITTED           # written last: the commit marker

A step is written as ``step_%09d.tmp`` and renamed only after
``_COMMITTED``, so a crash leaves no half-written step that a restore
would read.  Paths are :func:`..weights.flatten`'s (``params/blocks/l0/
attn/wq``), the strings the reference makes from the same dict tree.  A
bf16 leaf (or another type numpy cannot name, such as fp8) is stored as
the ``uint16`` (``uint8``) view of its bits under its own dtype name
(``"bfloat16"``), as the reference stores an ``ml_dtypes`` leaf; it is read
back through ``torch.Tensor.view``, so nothing here imports ``ml_dtypes``.
A Python int is stored as ``np.asarray(int)`` (int64) and comes back as an
int.  So a step saved by either package loads in the other.

A sharded tree (``parallel.fsdp``: each rank holds its shard of each leaf)
is saved with ``shardings`` (the fitted specs) and ``mesh``: each leaf in
turn is gathered whole, copied to the host on rank 0 and dropped, and rank
0 writes the same files as for an unsharded tree.
``load_checkpoint`` with ``shardings`` and ``mesh`` reads each leaf and
keeps this rank's shard, for any mesh the specs fit.

:class:`CheckpointManager.async_save` copies the tree to host memory
before it returns and writes it on a thread, which gets numpy arrays only
and launches no CUDA work; ``wait()`` joins it and raises its error.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..parallel.fsdp import gather_leaf, shard_slices
from ..weights import flatten, unflatten

# float types that numpy has; any other floating torch dtype (bf16, fp8) is
# stored as the unsigned view of its bits
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (the array its file holds, the manifest's dtype name), in
    host memory that no later change to ``leaf`` reaches: a tensor is
    copied (``.cpu()`` of a CPU tensor would share its storage)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", memory_format=torch.contiguous_format,
                             copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if t.is_floating_point() and t.dtype not in _NUMPY_FLOATS:
            bits = torch.int16 if t.element_size() == 2 else torch.int8
            unsigned = np.uint16 if t.element_size() == 2 else np.uint8
            return t.view(bits).numpy().view(unsigned), name
        return t.numpy(), name
    arr = np.array(leaf)
    name = str(arr.dtype)
    if arr.dtype.kind not in "biufc":   # ml_dtypes (bfloat16, fp8, ...)
        arr = arr.view(np.uint16 if arr.dtype.itemsize == 2 else np.uint8)
    return arr, name


def _snapshot(tree, shardings=None,
              mesh=None) -> Optional[Dict[str, Tuple[np.ndarray, str]]]:
    """The tree in host memory; a sharded tree's leaves gathered whole
    (every rank takes part) one at a time, each dropped once rank 0 has
    copied it, and None on a rank that does not write."""
    if shardings is None:
        return {path: _host(leaf) for path, leaf in flatten(tree).items()}
    specs = flatten(shardings)
    host = {}
    for path, leaf in flatten(tree).items():
        if isinstance(leaf, torch.Tensor):
            leaf = gather_leaf(leaf, specs[path], mesh)
        if mesh.rank == 0:
            host[path] = _host(leaf)
    return host if mesh.rank == 0 else None


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr)) & 0xFFFFFFFF


def _committed_steps(directory: pathlib.Path) -> List[int]:
    """Committed steps, ascending.  A ``.tmp`` directory is never one, even
    holding ``_COMMITTED`` (a crash between the marker and the rename)."""
    if not directory.exists():
        return []
    return sorted(int(p.name.split("_")[1]) for p in directory.glob("step_*")
                  if p.is_dir() and not p.name.endswith(".tmp")
                  and (p / "_COMMITTED").exists())


def _write(directory: pathlib.Path, step: int,
           host: Dict[str, Tuple[np.ndarray, str]], keep: int) -> pathlib.Path:
    tmp = directory / f"step_{step:09d}.tmp"
    final = directory / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": {}}
    for i, (key, (arr, dtype_name)) in enumerate(sorted(host.items())):
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname,
            "shape": list(arr.shape),
            "dtype": dtype_name,
            "crc32": _crc(arr),
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "_COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(directory, keep)
    return final


def _gc(directory: pathlib.Path, keep: int) -> None:
    """Delete all but the ``keep`` latest committed steps."""
    for s in _committed_steps(directory)[:-keep] if keep > 0 else []:
        shutil.rmtree(directory / f"step_{s:09d}", ignore_errors=True)


def save_checkpoint(directory, step: int, tree, *, keep: int = 3,
                    shardings=None, mesh=None) -> Optional[pathlib.Path]:
    """Write ``tree`` (nested dicts of tensors, numpy arrays and Python
    numbers) as committed step ``step``; keep the ``keep`` latest.  With
    ``shardings`` and ``mesh`` the tree holds this rank's shards, which
    every rank gathers and rank 0 writes (the others return None)."""
    host = _snapshot(tree, shardings, mesh)
    if host is None:
        return None
    return _write(pathlib.Path(directory), step, host, keep)


def latest_step(directory) -> Optional[int]:
    steps = _committed_steps(pathlib.Path(directory))
    return steps[-1] if steps else None


def _array_of(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A loaded file as a tensor of the manifest's dtype (bit views back to
    bf16 or fp8)."""
    if str(arr.dtype) == dtype_name:
        return torch.from_numpy(arr)
    dtype = getattr(torch, dtype_name, None)
    if not isinstance(dtype, torch.dtype) or dtype.itemsize != \
            arr.dtype.itemsize:
        raise ValueError(f"checkpoint dtype {dtype_name!r} stored as "
                         f"{arr.dtype} cannot be read")
    bits = np.int16 if arr.dtype.itemsize == 2 else np.int8
    return torch.from_numpy(arr.view(bits)).view(dtype)


def load_checkpoint(directory, step: int, tree_like, *, device=None,
                    verify: bool = True, shardings=None, mesh=None):
    """Restore step ``step`` into the structure of ``tree_like``.

    Each leaf gets the shape (checked: ``ValueError``) and the dtype of
    ``tree_like``'s leaf, and the device of that leaf, or ``device`` where
    given; a Python number comes back as its type, and any other leaf as
    the array the file holds.  ``verify`` checks each file's crc32
    (``IOError``); a leaf missing from the step raises ``KeyError``, a step
    that is not committed ``FileNotFoundError``.  With ``shardings`` (a
    tree of fitted specs, ``parallel.sharding``) and ``mesh``, as the
    reference's ``shardings`` re-shard onto the current mesh: ``tree_like``
    has the whole leaves' shapes (the meta device will do, with
    ``device``), and each tensor leaf comes back as this rank's shard.
    """
    directory = pathlib.Path(directory) / f"step_{step:09d}"
    if not (directory / "_COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {directory}")
    manifest = json.loads((directory / "manifest.json").read_text())
    specs = flatten(shardings) if shardings is not None else {}

    out: Dict[str, Any] = {}
    for key, like in flatten(tree_like).items():
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(directory / meta["file"])
        if verify and _crc(arr) != meta["crc32"]:
            raise IOError(f"crc mismatch for {key} "
                          f"(corrupt checkpoint {directory})")
        want_shape = (tuple(like.shape) if isinstance(like, torch.Tensor)
                      else tuple(np.shape(like)))   # () for Python numbers
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"expected {want_shape}")
        if isinstance(like, torch.Tensor):
            if key in specs:
                arr = np.array(arr[shard_slices(specs[key], arr.shape, mesh)])
            out[key] = _array_of(arr, meta["dtype"]).to(
                device=like.device if device is None else device,
                dtype=like.dtype)
        elif want_shape == () and not isinstance(like, np.ndarray):
            out[key] = type(like)(arr)
        else:
            out[key] = arr
    return unflatten(out)


class CheckpointManager:
    """Checkpoints in one directory, with one async save in flight at a
    time."""

    def __init__(self, directory, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self) -> None:
        """Join the save in flight; raise the error it met, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def async_save(self, step: int, tree, shardings=None, mesh=None) -> None:
        """Copy ``tree`` to host memory now (gathered whole, for a sharded
        tree), write it on a thread (rank 0's)."""
        self.wait()
        host = _snapshot(tree, shardings, mesh)
        if host is None:
            return

        def work():
            try:
                _write(self.directory, step, host, self.keep)
            except BaseException as e:  # noqa: BLE001 - raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree, shardings=None, mesh=None) -> None:
        self.wait()
        save_checkpoint(self.directory, step, tree, keep=self.keep,
                        shardings=shardings, mesh=mesh)

    def restore_latest(self, tree_like, device=None, shardings=None,
                       mesh=None) -> Tuple[Optional[int], Any]:
        """(latest committed step, its tree), or (None, None)."""
        step = latest_step(self.directory)
        if step is None:
            return None, None
        return step, load_checkpoint(self.directory, step, tree_like,
                                     device=device, shardings=shardings,
                                     mesh=mesh)
