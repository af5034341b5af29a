"""Pytree files: ``.npz`` payload + JSON manifest, content-addressed (the
port's copy of the JAX package's ``training/checkpoints.py`` file
format, which the Zoo's registry stores weights in).

Containers are nested dicts, so the tree is rebuilt from '/'-joined leaf
paths without pickling. Saves are atomic (temp file + ``os.replace``);
loads fail fast with :class:`CheckpointError` on a truncated or corrupt
archive, a manifest whose leaf inventory disagrees with the payload, or
a content-hash mismatch.

The format is the JAX package's, leaf for leaf, so a zoo written by one
package is read by the other:

* ``tree_hash`` hashes each sorted key, shape, dtype *name* and the raw
  bytes, so a JAX tree and a port tree with the same bits hash the same.
* A bfloat16 leaf is written as its raw 2-byte payload (numpy stores it
  as ``|V2``, as it stores JAX's ``ml_dtypes.bfloat16`` arrays) with
  ``"bfloat16"`` in the manifest, and read back as ``torch.bfloat16``.
  numpy has no bfloat16 of its own, and the port needs none.

One difference: a ``|V2`` leaf that the manifest calls ``"bfloat16"`` is
accepted here, where the JAX loader compares ``"|V2"`` with
``"bfloat16"`` and raises (ROADMAP section 3): the port reads a JAX-written
bf16 state, JAX reads a port-written one only in float32.

A train state (``save_train_state`` / ``load_train_state``) is JAX's
layout: ``<dir>/params`` and ``<dir>/opt_state`` pytrees (the optimizer
state's ``m``, ``v`` and 0-d int32 ``step``), each manifest carrying the
step as ``"step"``.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.pytree import tree_flatten_with_path
from repro_torch.kernels.dispatch import resolve_device

_RAW_BF16 = np.dtype("V2")


class CheckpointError(IOError):
    """A checkpoint failed to load: truncated/corrupt payload, manifest
    mismatch, or content-hash mismatch."""


def _raw(leaf) -> Tuple[np.ndarray, str]:
    """A leaf (torch tensor or numpy array) as (numpy payload, dtype
    name); bfloat16 as its raw 2-byte payload."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_RAW_BF16), "bfloat16"
        a = t.numpy()
        return a, a.dtype.name
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":          # an ml_dtypes array
        return a.view(_RAW_BF16), "bfloat16"
    return a, a.dtype.name


def _flatten(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {"/".join(str(k) for k in path): _raw(leaf)
            for path, leaf in tree_flatten_with_path(tree)}


def _unflatten(flat: Dict[str, Any]) -> Any:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _hash_flat(flat: Dict[str, Tuple[np.ndarray, str]]) -> str:
    h = hashlib.sha256()
    for key in sorted(flat):
        arr, name = flat[key]
        h.update(key.encode())
        h.update(str(arr.shape).encode())
        h.update(name.encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def tree_hash(tree) -> str:
    return _hash_flat(_flatten(tree))


def _atomic_write(path: Path, write_fn) -> None:
    """Write through a same-directory temp file + ``os.replace`` so the
    destination is only ever absent, the old version, or complete."""
    tmp = path.parent / f".{path.name}.tmp-{os.getpid()}"
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if tmp.exists():
            tmp.unlink()


def save_pytree(path: os.PathLike, tree, extra: dict | None = None) -> str:
    """Writes <path>.npz and <path>.json atomically; returns the
    content hash."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(tree)

    def _write_npz(tmp: Path) -> None:
        with tmp.open("wb") as fh:
            np.savez(fh, **{k: a for k, (a, _) in flat.items()})
    _atomic_write(Path(str(path) + ".npz"), _write_npz)
    digest = _hash_flat(flat)
    manifest = {"hash": digest,
                "leaves": {k: {"shape": list(a.shape), "dtype": name}
                           for k, (a, name) in flat.items()}}
    manifest.update(extra or {})
    _atomic_write(Path(str(path) + ".json"),
                  lambda tmp: tmp.write_text(json.dumps(manifest, indent=1)))
    return digest


def _name_of(arr: np.ndarray, want: str | None) -> str:
    """The dtype name of a loaded payload: a 2-byte void is bfloat16."""
    if arr.dtype == _RAW_BF16:
        return "bfloat16" if want in (None, "bfloat16") else str(arr.dtype)
    return arr.dtype.name


def _validate_manifest(path: Path, manifest: dict, flat) -> None:
    leaves = manifest.get("leaves")
    if not isinstance(leaves, dict):
        return                      # pre-manifest checkpoint: hash-only
    missing = sorted(set(leaves) - set(flat))
    extra = sorted(set(flat) - set(leaves))
    if missing or extra:
        raise CheckpointError(
            f"checkpoint {path}: payload leaves disagree with manifest "
            f"(missing={missing[:3]}, unexpected={extra[:3]})")
    for key, want in leaves.items():
        arr, name = flat[key]
        if list(arr.shape) != list(want.get("shape", [])):
            raise CheckpointError(
                f"checkpoint {path}: leaf {key!r} has shape "
                f"{list(arr.shape)}, manifest says {want.get('shape')}")
        if name != want.get("dtype"):
            raise CheckpointError(
                f"checkpoint {path}: leaf {key!r} has dtype "
                f"{name}, manifest says {want.get('dtype')}")


def _to_torch(arr: np.ndarray, name: str, device) -> torch.Tensor:
    if name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device)


def load_pytree(path: os.PathLike, verify: bool = True, device=None):
    """The tree written at ``path`` as torch tensors on ``device``: CUDA
    unless the caller names another (``dispatch.resolve_device``)."""
    device = resolve_device(device)
    path = Path(path)
    try:
        with np.load(str(path) + ".npz") as z:
            payload = {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except Exception as e:         # truncated zip, bad member, ...
        raise CheckpointError(
            f"checkpoint {path}: payload unreadable "
            f"(truncated or corrupt archive): {e}") from e
    manifest = None
    if Path(str(path) + ".json").exists():
        try:
            with open(str(path) + ".json") as f:
                manifest = json.load(f)
        except ValueError as e:
            if verify:
                raise CheckpointError(
                    f"checkpoint {path}: manifest unreadable: {e}") from e
    leaves = (manifest or {}).get("leaves")
    leaves = leaves if isinstance(leaves, dict) else {}
    flat = {k: (a, _name_of(a, leaves.get(k, {}).get("dtype")))
            for k, a in payload.items()}
    if verify and manifest is not None:
        _validate_manifest(path, manifest, flat)
        if manifest.get("hash") and manifest["hash"] != _hash_flat(flat):
            raise CheckpointError(
                f"checkpoint {path}: content hash mismatch")
    return _unflatten({k: _to_torch(a, name, device)
                       for k, (a, name) in flat.items()})


def save_train_state(path, step: int, params, opt_state, extra=None):
    """Writes ``<path>/params`` and ``<path>/opt_state`` (with ``step``
    and ``extra`` in both manifests). The trees may be a train step's
    state, which on the card is its captured graph's buffers: each leaf
    is read back after the work queued on it."""
    meta = {"step": int(step)}
    meta.update(extra or {})
    save_pytree(Path(path) / "params", params, extra=meta)
    save_pytree(Path(path) / "opt_state", opt_state, extra=meta)


def load_train_state(path, device=None):
    """(step, params, opt_state) of a train state written by either
    package, the trees as tensors on ``device`` (CUDA unless the caller
    names another). A train step given such a state copies it into its
    own buffers (``train_loop.TrainProgram``), from any device."""
    params = load_pytree(Path(path) / "params", device=device)
    opt_state = load_pytree(Path(path) / "opt_state", device=device)
    with open(Path(path) / "params.json") as f:
        step = json.load(f).get("step", 0)
    return step, params, opt_state
