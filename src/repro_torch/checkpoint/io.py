"""Msgpack pytree checkpoints, byte-compatible with ``repro/checkpoint/io.py``.

A checkpoint is a flat ``{path: {dtype, shape, data}}`` map; paths join dict
keys (and list indices) with "/" in sorted-key order, as JAX flattens a
pytree, so the same tree packs to the same bytes in both packages and a
checkpoint written by either loads in the other. This is the weight bridge
between them; ``params_from_numpy`` / ``params_to_numpy`` are the in-memory
half of it.

``msgpack`` is imported inside the functions that need it.
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch


def _items(tree, prefix=""):
    """(path, leaf) pairs in JAX's flattening order (dict keys sorted, None
    is an empty subtree)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return tuple(_map(fn, v) for v in tree)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _to_numpy(leaf):
    """(numpy array, dtype name); bf16 tensors travel as their raw bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_numpy(arr, device):
    """A tensor from a numpy array; an ``ml_dtypes`` bfloat16 array (what
    JAX hands over) keeps its bits as torch.bfloat16."""
    arr = np.array(arr, copy=True, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dict/list of numpy arrays (e.g. ``jax.device_get(params)``)
    -> the same structure of tensors on ``device``. A NamedTuple (a JAX
    ``TrainState`` or ``LossScaleState``, an optimizer state inside it)
    becomes a plain tuple in field order, for the port's twin type to take:
    ``TrainState(*params_from_numpy(jax_state))``."""
    return _map(lambda a: _from_numpy(np.asarray(a), device), tree)


def params_to_numpy(tree):
    """Tensors -> numpy arrays (f32 etc. as they are; bf16 as float32,
    which holds every bf16 value exactly)."""
    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _map(conv, tree)


def _flatten(tree) -> dict:
    flat = {}
    for key, leaf in _items(tree):
        arr, dtype = _to_numpy(leaf)
        flat[key] = {"dtype": dtype, "shape": list(arr.shape),
                     "data": arr.tobytes()}
    return flat


def atomic_write(path: str, data: bytes) -> None:
    """Write-then-rename, so an interrupted write never leaves a truncated
    file at ``path``."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, "." + os.path.basename(path) + ".tmp")
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def pack_pytree(tree: Any) -> bytes:
    """The exact byte payload ``save_pytree`` writes."""
    import msgpack
    return msgpack.packb(_flatten(tree), use_bin_type=True)


def save_pytree(path: str, tree: Any) -> None:
    atomic_write(path, pack_pytree(tree))


def _decode_leaf(rec, device):
    if rec["dtype"] == "bfloat16":
        arr = np.frombuffer(rec["data"], dtype=np.int16).reshape(rec["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).to(device)
    arr = np.frombuffer(rec["data"], dtype=rec["dtype"]).reshape(rec["shape"])
    return torch.from_numpy(arr.copy()).to(device)


def load_pytree(path: str, template: Any):
    """Restore into the structure of ``template`` (a tree of tensors; each
    leaf is replaced by the checkpoint's, on the template leaf's device).
    A missing leaf or a shape mismatch raises."""
    import msgpack
    with open(path, "rb") as f:
        raw = f.read()
    payload = msgpack.unpackb(raw, raw=False)
    restored = {}
    for key, leaf in _items(template):
        if key not in payload:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        rec = payload[key]
        want = tuple(leaf.shape)
        if tuple(rec["shape"]) != want:
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(rec['shape'])} "
                f"but the template expects {want}")
        restored[key] = _decode_leaf(rec, leaf.device)

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        return None if tree is None else restored[prefix[:-1]]
    return rebuild(template)
