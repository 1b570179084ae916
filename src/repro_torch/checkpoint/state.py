"""Train-state checkpoints: periodic snapshots and exact mid-phase resume.
Twin of ``repro/checkpoint/state.py``.

A layer over ``save_pytree``/``load_pytree`` that knows the phase engine's
``TrainState`` (``repro_torch.train.loop``):

  * ``save_train_state`` / ``load_train_state`` -- a whole TrainState
    (bundle, optimizer state, step, EMA, phase tag, rng, loss-scale state),
    the phase-2 form with its leading W axis included. A JSON sidecar
    (``<file>.json``), written first, carries the metadata that picks a
    resume point without reading arrays, and the snapshot's checksum.
  * ``Checkpointer`` -- snapshots at epoch-aligned steps, pruned per tag.
    Tags: ``phase1`` (mid-phase-1), ``phase1_final`` (phase 1's result and
    its summary metrics, the anchor of a phase-2 resume), ``phase2``
    (mid-phase-2, stacked).
  * ``find_resume_point`` -- the newest usable snapshot in a directory, in
    the priority phase2 > phase1_final > phase1.
  * publish snapshots (``save_publish`` and the functions after it): the
    averaged parameter tree that live serving reads. Plain param trees,
    not TrainStates, and invisible to ``list_checkpoints`` and
    ``find_resume_point``: a training run never resumes from an average.

On disk each leaf lies under the reference's key path in the reference's
dtype: ``step`` int32, ``rng`` uint32[2] (uint32[W, 2] in phase 2), the
loss-scale state under ``scale/.scale``, ``scale/.growth_count`` and
``scale/.skipped``, as JAX flattens a NamedTuple. So the same state
gives the same bytes from either package, and a snapshot of one resumes
in the other. A restore gives each leaf back in the port's dtype (int64
``step`` and ``rng``).

Restores are exact: the resumed run takes the same steps on bit-identical
state, so its parameters and metric logs equal an uninterrupted run's
bitwise (``tests/test_torch_resume.py``).
"""
from __future__ import annotations

import json
import os
import re
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import (atomic_write, checksum_bytes,
                                       load_pytree, pack_pytree,
                                       payload_intact)
from repro_torch.train.loop import TrainState

_FILE_RE = re.compile(r"^(phase1_final|phase1|phase2)-step(\d+)\.msgpack$")
# resume priority: a phase2 snapshot supersedes phase1_final supersedes phase1
_TAG_ORDER = {"phase1": 0, "phase1_final": 1, "phase2": 2}
# publishable averaged-params snapshots (not resume points: _FILE_RE above
# does not match them)
_PUBLISH_RE = re.compile(r"^publish-gen(\d+)-step(\d+)\.msgpack$")


def _state_tree(state: TrainState) -> Dict[str, Any]:
    """The state as a dict of its fields (the restore template; the
    loss-scale NamedTuple packs under ``scale/.field``, as JAX's)."""
    return dict(state._asdict())


def _narrow(t: torch.Tensor, dtype, what: str) -> np.ndarray:
    arr = t.detach().cpu().numpy()
    out = arr.astype(dtype)
    if not np.array_equal(out.astype(arr.dtype), arr):
        raise ValueError(f"TrainState.{what} does not fit {np.dtype(dtype)}")
    return out


def _disk_tree(state: TrainState) -> Dict[str, Any]:
    """The state under the reference's key paths in the reference's
    dtypes: the tree a snapshot packs."""
    return dict(_state_tree(state),
                step=_narrow(state.step, np.int32, "step"),
                rng=_narrow(state.rng, np.uint32, "rng"))


def state_step(state: TrainState) -> int:
    """Global step of a state; a phase-2 state holds one per worker (all
    equal: the workers advance in lockstep)."""
    return int(state.step.reshape(-1)[0])


def _n_workers(state: TrainState) -> int:
    return int(state.step.reshape(-1).shape[0])


def save_train_state(path: str, state: TrainState,
                     meta: Optional[Dict[str, Any]] = None) -> None:
    """The sidecar first, then the snapshot, each written then renamed:
    directory scans key off the ``.msgpack``, so an interruption anywhere
    here leaves a whole (snapshot, sidecar) pair or no visible snapshot.
    The tree is packed once; the sidecar records the checksum of the bytes
    the snapshot then holds."""
    payload = pack_pytree(_disk_tree(state))
    meta = dict(meta or {}, checksum=checksum_bytes(payload))
    atomic_write(path + ".json", json.dumps(meta, indent=1).encode())
    atomic_write(path, payload)


def load_train_state(path: str, template: TrainState,
                     verify: bool = True) -> TrainState:
    """Restore a TrainState into the structure, shapes, dtypes and devices
    of ``template`` (built by the resuming process from the same config,
    e.g. the freshly stacked phase-2 state for a mid-phase-2 restore).

    A snapshot without ``scale`` leaves takes them from the template. With
    ``verify``, a checksum in the sidecar is checked against the bytes
    before they are unpacked (``checkpoint.io.ChecksumError``); a snapshot
    without one loads unchecked."""
    meta = read_meta(path)
    want = meta.get("checksum") if verify else None
    tree = load_pytree(path, _state_tree(template),
                       optional_prefixes=("scale/",), expected_checksum=want)
    return TrainState(**tree)


def checkpoint_workers(meta: Dict[str, Any]) -> Optional[int]:
    """The worker count a phase-2 snapshot's sidecar records, or None (a
    snapshot that predates it matches the resuming config)."""
    n = meta.get("n_workers")
    return int(n) if n is not None else None


def _map_state(fn, *states: TrainState) -> TrainState:
    """``fn`` over the leaves of one TrainState, or of several of one
    structure taken together."""
    def rec(*trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: rec(*(t[k] for t in trees)) for k in first}
        if isinstance(first, tuple):         # the loss-scale NamedTuple
            return type(first)(*(rec(*xs) for xs in zip(*trees)))
        return fn(*trees)
    return TrainState(*(rec(*xs) for xs in zip(*states)))


def shrink_worker_axis(state: TrainState, n_workers: int) -> TrainState:
    """Keep the first ``n_workers`` workers of a phase-2 stacked state.

    A snapshot of a W-worker run may be resumed by a run of W' < W workers
    (an elastic deployment that lost hosts): the kept workers go on on
    their own trajectories, the rest are dropped. Growing (W' > W) is
    refused: a cloned worker would share a trajectory with another, and
    the phase-2 average relies on independent workers."""
    ckpt_w = _n_workers(state)
    if n_workers == ckpt_w:
        return state
    if n_workers > ckpt_w:
        raise ValueError(
            f"cannot resume a {ckpt_w}-worker phase-2 checkpoint with "
            f"n_workers={n_workers}: cloned workers would not be "
            f"independent. Shrinking (n_workers <= {ckpt_w}) is supported; "
            f"to grow the ensemble, restart phase 2 from phase1_final.")
    return _map_state(lambda a: a[:n_workers].clone(), state)


def take_worker_axis(state: TrainState, positions) -> TrainState:
    """Keep the stacked-state rows at ``positions`` (an ordered selection
    without repeats). A prefix goes through ``shrink_worker_axis`` and its
    refusal to grow; any other selection gathers the rows. Each kept
    worker's row is moved, never mixed."""
    positions = [int(p) for p in positions]
    ckpt_w = _n_workers(state)
    if any(p < 0 or p >= ckpt_w for p in positions):
        raise ValueError(f"worker positions {positions} out of range for a "
                         f"{ckpt_w}-worker stacked state")
    if len(set(positions)) != len(positions):
        raise ValueError(f"duplicate worker positions: {positions}")
    if positions == list(range(len(positions))):
        return shrink_worker_axis(state, len(positions))
    return _map_state(lambda a: a[positions], state)


# marker key of the dict read_meta returns for a sidecar that exists but
# does not parse: such a snapshot cannot be tied to a checksum, and
# resume-point scans skip it. A missing sidecar is the legacy "no
# metadata" case ({}), still accepted.
SIDECAR_CORRUPT = "_sidecar_corrupt"


def read_meta(path: str) -> Dict[str, Any]:
    try:
        with open(path + ".json") as f:
            meta = json.load(f)
    except OSError:
        return {}
    except json.JSONDecodeError as e:
        warnings.warn(f"unreadable checkpoint sidecar {path}.json ({e}); "
                      f"treating the snapshot as unverifiable",
                      RuntimeWarning, stacklevel=2)
        return {SIDECAR_CORRUPT: True}
    if not isinstance(meta, dict):
        warnings.warn(f"checkpoint sidecar {path}.json is not a JSON "
                      f"object; treating the snapshot as unverifiable",
                      RuntimeWarning, stacklevel=2)
        return {SIDECAR_CORRUPT: True}
    return meta


def verify_snapshot(path: str, meta: Optional[Dict[str, Any]] = None) -> bool:
    """Whether a snapshot's bytes can be restored from: False for a corrupt
    sidecar; with a recorded checksum, the file's against it; without one,
    whether the payload unpacks (a truncation shows, a bit flip does not).
    """
    if meta is None:
        meta = read_meta(path)
    if meta.get(SIDECAR_CORRUPT):
        return False
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return False
    want = meta.get("checksum")
    if want is not None:
        return checksum_bytes(data) == want
    return payload_intact(data)


def list_checkpoints(directory: str) -> List[Dict[str, Any]]:
    """Every snapshot in ``directory`` as {path, tag, step, meta}."""
    if not directory or not os.path.isdir(directory):
        return []
    out = []
    for name in sorted(os.listdir(directory)):
        m = _FILE_RE.match(name)
        if not m:
            continue
        path = os.path.join(directory, name)
        out.append({"path": path, "tag": m.group(1),
                    "step": int(m.group(2)), "meta": read_meta(path)})
    return out


def find_resume_point(directory: str) -> Optional[Dict[str, Any]]:
    """The snapshot a resumed run restarts from, or None: the highest (tag
    priority, step) that passes ``verify_snapshot``. A damaged one is
    skipped with a warning and the one before it wins."""
    ckpts = list_checkpoints(directory)
    for c in sorted(ckpts, key=lambda c: (_TAG_ORDER[c["tag"]], c["step"]),
                    reverse=True):
        if verify_snapshot(c["path"], c["meta"]):
            return c
        warnings.warn(f"skipping corrupt checkpoint {c['path']}; falling "
                      f"back to the previous verified snapshot",
                      RuntimeWarning, stacklevel=2)
    return None


def publish_path(directory: str, generation: int, step: int) -> str:
    return os.path.join(
        directory, f"publish-gen{generation:08d}-step{step:08d}.msgpack")


def save_publish(directory: str, generation: int, step: int, params,
                 meta: Optional[Dict[str, Any]] = None) -> str:
    """Write a publishable averaged-params snapshot, sidecar first, each
    file written then renamed, as ``save_train_state``. Returns its path.
    """
    os.makedirs(directory, exist_ok=True)
    path = publish_path(directory, generation, step)
    payload = pack_pytree(params)
    atomic_write(path + ".json",
                 json.dumps(dict(meta or {}, generation=generation,
                                 step=step,
                                 checksum=checksum_bytes(payload)),
                            indent=1).encode())
    atomic_write(path, payload)
    return path


def list_publishes(directory: str) -> List[Dict[str, Any]]:
    """Complete publish snapshots in ``directory`` as
    {path, generation, step, meta}, by generation."""
    if not directory or not os.path.isdir(directory):
        return []
    out = []
    for name in sorted(os.listdir(directory)):
        m = _PUBLISH_RE.match(name)
        if not m:
            continue
        path = os.path.join(directory, name)
        out.append({"path": path, "generation": int(m.group(1)),
                    "step": int(m.group(2)), "meta": read_meta(path)})
    return sorted(out, key=lambda p: p["generation"])


def find_latest_publish(directory: str) -> Optional[Dict[str, Any]]:
    """The newest publish snapshot that passes ``verify_snapshot``, or
    None; a damaged generation falls back to the one before, with a
    warning."""
    for pub in reversed(list_publishes(directory)):
        if verify_snapshot(pub["path"], pub["meta"]):
            return pub
        warnings.warn(f"skipping corrupt publish snapshot {pub['path']}; "
                      f"falling back to the previous generation",
                      RuntimeWarning, stacklevel=2)
    return None


def load_publish(path: str, template) -> Any:
    """Restore a published parameter tree into ``template``'s structure."""
    return load_pytree(path, template)


class Checkpointer:
    """Periodic epoch-aligned snapshots of a TrainState.

    ``every`` is a step count. The phase engine surfaces state at chunk
    boundaries only, so a snapshot is written at the first boundary at
    least ``every`` steps past the tag's previous one (a multiple of
    steps_per_epoch makes the cadence exact). ``keep`` bounds the
    snapshots kept per rolling tag; ``phase1_final`` is never pruned (a
    phase-2 resume needs it). The cadence starts from the snapshots
    already on disk, so that a resumed run does not snapshot at its first
    boundary.
    """

    def __init__(self, directory: str, every: int = 0, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        self._last_saved: Dict[str, int] = {}
        # paths this process wrote (and so knows good): _prune's guard of
        # the last good snapshot need not read them again
        self._verified: set = set()
        if directory:
            os.makedirs(directory, exist_ok=True)
            for c in list_checkpoints(directory):
                self._last_saved[c["tag"]] = max(
                    self._last_saved.get(c["tag"], 0), c["step"])

    def _path(self, tag: str, step: int) -> str:
        return os.path.join(self.directory, f"{tag}-step{step:08d}.msgpack")

    def save(self, tag: str, state: TrainState,
             meta: Optional[Dict[str, Any]] = None) -> str:
        step = state_step(state)
        path = self._path(tag, step)
        meta = dict(meta or {}, tag=tag, step=step)
        # the worker count from the state's leading axis, which a resume
        # builds its template from
        if state.step.dim() >= 1:
            meta["n_workers"] = _n_workers(state)
        save_train_state(path, state, meta)
        self._last_saved[tag] = step
        self._verified.add(path)
        self._prune(tag)
        return path

    def maybe_save(self, tag: str, state: TrainState,
                   meta: Optional[Dict[str, Any]] = None) -> Optional[str]:
        if self.every <= 0:
            return None
        step = state_step(state)
        if step <= 0 or step - self._last_saved.get(tag, 0) < self.every:
            return None
        return self.save(tag, state, meta)

    def _good(self, entry: Dict[str, Any]) -> bool:
        return (entry["path"] in self._verified
                or verify_snapshot(entry["path"], entry["meta"]))

    def _prune(self, tag: str) -> None:
        if tag == "phase1_final" or self.keep <= 0:
            return
        mine = [c for c in list_checkpoints(self.directory)
                if c["tag"] == tag]
        stale, kept = mine[:-self.keep], mine[-self.keep:]
        # never delete the last good snapshot: if none of the kept ones
        # verifies, spare the newest good one of the stale
        if stale and not any(self._good(c) for c in reversed(kept)):
            for c in reversed(stale):
                if self._good(c):
                    stale.remove(c)
                    break
        for entry in stale:
            for p in (entry["path"], entry["path"] + ".json"):
                try:
                    os.remove(p)
                except OSError:
                    pass
