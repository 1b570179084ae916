"""Msgpack pytree checkpoints, byte-compatible with ``repro/checkpoint/io.py``.

A checkpoint is a flat ``{path: {dtype, shape, data}}`` map; paths join dict
keys (and list indices) with "/" in sorted-key order, as JAX flattens a
pytree, so the same tree packs to the same bytes in both packages and a
checkpoint written by either loads in the other. This is the weight bridge
between them; ``params_from_numpy`` / ``params_to_numpy`` are the in-memory
half of it.

Snapshots carry a content checksum (``checksum_bytes``, the reference's
crc32 string) that ``load_pytree(expected_checksum=)`` verifies before it
unpacks; a mismatch raises ``ChecksumError``.

``msgpack`` is imported inside the functions that need it.
"""
from __future__ import annotations

import os
import zlib
from typing import Any, Optional

import numpy as np
import torch


class ChecksumError(ValueError):
    """Snapshot bytes do not match the checksum recorded in their sidecar
    (bit rot, a torn copy, an out-of-band truncation)."""


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _items(tree, prefix=""):
    """(path, leaf) pairs in JAX's flattening order and under its key paths
    (dict keys sorted; a NamedTuple's fields in field order, each keyed
    ``.field``; None is an empty subtree)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif _is_namedtuple(tree):
        for f, v in zip(tree._fields, tree):
            yield from _items(v, f"{prefix}.{f}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix[:-1], tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
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


def checksum_bytes(data: bytes) -> str:
    """Content checksum of a snapshot payload, in sidecar string form."""
    return f"crc32:{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def payload_intact(data: bytes) -> bool:
    """Integrity probe for a payload with no recorded checksum: a
    truncated msgpack stream fails to unpack. A same-length bit flip needs
    the checksum to show."""
    import msgpack
    try:
        msgpack.unpackb(data, raw=False)
    except Exception:    # msgpack raises several types on a torn stream
        return False
    return True


def save_pytree(path: str, tree: Any) -> None:
    atomic_write(path, pack_pytree(tree))


def _decode_leaf(rec) -> torch.Tensor:
    """A record as a CPU tensor of the file's dtype (uint32, which torch
    holds with few ops, as int64)."""
    if rec["dtype"] == "bfloat16":
        arr = np.frombuffer(rec["data"], dtype=np.int16).reshape(rec["shape"])
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(rec["data"], dtype=rec["dtype"]).reshape(rec["shape"])
    if arr.dtype == np.uint32:
        arr = arr.astype(np.int64)
    return torch.from_numpy(arr.copy())


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def _as_template(t: torch.Tensor, leaf: torch.Tensor, key: str):
    """``t`` in the dtype of the template ``leaf``, which must hold every
    value exactly."""
    if t.dtype == leaf.dtype:
        return t
    out = t.to(leaf.dtype)
    if not _same_bits(out.to(t.dtype), t):
        raise ValueError(
            f"checkpoint leaf {key!r} holds {t.dtype} values that the "
            f"template's {leaf.dtype} cannot hold exactly")
    return out


def load_pytree(path: str, template: Any, optional_prefixes: tuple = (),
                expected_checksum: Optional[str] = None):
    """Restore into the structure of ``template`` (a tree of tensors; each
    leaf is replaced by the checkpoint's, in the template leaf's dtype and
    on its device). A missing leaf or a shape mismatch raises, and so does
    a leaf whose values the template's dtype cannot hold exactly.

    Leaves whose key starts with one of ``optional_prefixes`` keep the
    template's value when the snapshot predates them. With
    ``expected_checksum`` (the sidecar's), the raw bytes are verified
    before they are unpacked; a mismatch raises ``ChecksumError``."""
    import msgpack
    with open(path, "rb") as f:
        raw = f.read()
    if expected_checksum is not None:
        got = checksum_bytes(raw)
        if got != expected_checksum:
            raise ChecksumError(
                f"checkpoint {path} is corrupt: content checksum {got} != "
                f"recorded {expected_checksum}")
    payload = msgpack.unpackb(raw, raw=False)
    restored = {}
    for key, leaf in _items(template):
        if key not in payload:
            if optional_prefixes and key.startswith(optional_prefixes):
                restored[key] = leaf
                continue
            raise KeyError(f"checkpoint missing leaf {key!r}")
        rec = payload[key]
        want = tuple(leaf.shape)
        if tuple(rec["shape"]) != want:
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {tuple(rec['shape'])} "
                f"but the template expects {want}")
        restored[key] = _as_template(_decode_leaf(rec), leaf,
                                     key).to(leaf.device)

    def rebuild(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
        if _is_namedtuple(tree):
            return type(tree)(*(rebuild(v, f"{prefix}.{f}/")
                                for f, v in zip(tree._fields, tree)))
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, f"{prefix}{i}/")
                              for i, v in enumerate(tree))
        return None if tree is None else restored[prefix[:-1]]
    return rebuild(template)
