"""File-based per-worker heartbeat liveness: twin of
``repro/dist/heartbeat.py``.

The elastic phase 3 (``repro_torch.core.averaging.ElasticAverage``) takes
per-worker *arrival* times: how late each worker's report is against the
averaging deadline. Without heartbeats they are simulated (the launcher's
``--lost-workers``); this module gives real ones, through the file system.

Protocol
--------
Each worker (or the one launcher that drives them all) rewrites one beacon
file ``hb-worker<N>.json`` at chunk boundaries, through ``atomic_write``
(write, then rename), so that a monitor never reads a torn one:

    {"worker": N, "seq": k, "t": <clock seconds>, "step": <train step>}

The file's name and bytes are the reference's, so a monitor of either
package reads the other's beacons. The monitor derives everything from a
beacon's staleness when it polls:

  * **live mask** -- a worker is live iff its beacon exists and is no
    staler than ``timeout_s``;
  * **elastic arrivals** -- a live worker arrives as late as its beacon is
    stale (a slow but live worker can pass the deadline and exercise the
    backoff); a dead one (stale past ``timeout_s``, or never seen) arrives
    ``inf`` and is dropped from the average.

Every class takes an injectable ``clock`` (``repro_torch.testing.faults.
FakeClock`` in the tests), so no test synchronizes by sleeping. The knobs
are ``DistConfig.heartbeat_dir``, ``heartbeat_interval_s`` and
``heartbeat_timeout_s``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.checkpoint.io import atomic_write

_INF = float("inf")


def heartbeat_path(directory: str, worker: int) -> str:
    return os.path.join(directory, f"hb-worker{int(worker)}.json")


class HeartbeatWriter:
    """One worker's beacon. ``beat`` always writes; ``maybe_beat`` keeps
    ``interval_s`` between beats, so that hooks on fast chunks do not
    hammer a shared file system."""

    def __init__(self, directory: str, worker: int,
                 interval_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        if interval_s < 0:
            raise ValueError(f"interval_s must be >= 0, got {interval_s}")
        self.directory = directory
        self.worker = int(worker)
        self.interval_s = float(interval_s)
        self.clock = clock
        self.seq = 0
        self._last_beat: Optional[float] = None
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        return heartbeat_path(self.directory, self.worker)

    def beat(self, step: Optional[int] = None) -> None:
        now = float(self.clock())
        self.seq += 1
        atomic_write(self.path, json.dumps(
            {"worker": self.worker, "seq": self.seq, "t": now,
             "step": None if step is None else int(step)}).encode())
        self._last_beat = now

    def maybe_beat(self, step: Optional[int] = None) -> bool:
        now = float(self.clock())
        if (self._last_beat is not None
                and now - self._last_beat < self.interval_s):
            return False
        self.beat(step)
        return True


class HeartbeatMonitor:
    """Reads every worker's beacon and turns staleness into liveness and
    elastic arrivals. It keeps no state between polls but the directory:
    a monitor that comes up after a crash sees the truth at once."""

    def __init__(self, directory: str, n_workers: int, timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        if n_workers <= 0:
            raise ValueError(f"n_workers must be positive, got {n_workers}")
        if timeout_s <= 0:
            raise ValueError(f"timeout_s must be positive, got {timeout_s}")
        self.directory = directory
        self.n_workers = int(n_workers)
        self.timeout_s = float(timeout_s)
        self.clock = clock

    def poll(self) -> Dict[int, Optional[dict]]:
        """The latest beacon of each worker id (None: never beat, or
        unreadable). ``atomic_write`` rules out a torn beacon, but one
        damaged from outside reads as absent: a missed beat, not a crash.
        """
        out: Dict[int, Optional[dict]] = {}
        for w in range(self.n_workers):
            try:
                with open(heartbeat_path(self.directory, w)) as f:
                    rec = json.load(f)
                out[w] = rec if isinstance(rec, dict) else None
            except (OSError, json.JSONDecodeError):
                out[w] = None
        return out

    def staleness(self, now: Optional[float] = None) -> List[float]:
        """Seconds since each worker's last beat (inf: never seen)."""
        now = float(self.clock()) if now is None else float(now)
        beacons = self.poll()
        out = []
        for w in range(self.n_workers):
            rec = beacons[w]
            if rec is None or "t" not in rec:
                out.append(_INF)
            else:
                out.append(max(0.0, now - float(rec["t"])))
        return out

    def live_mask(self, now: Optional[float] = None) -> np.ndarray:
        """Boolean (n_workers,): live iff staleness <= timeout_s."""
        stale = self.staleness(now)
        return np.asarray([s <= self.timeout_s for s in stale], bool)

    def dead_among(self, workers: Sequence[int],
                   now: Optional[float] = None) -> List[int]:
        """The ids of ``workers`` that are past the liveness timeout."""
        mask = self.live_mask(now)
        return [int(w) for w in workers if not mask[int(w)]]

    def arrivals(self, workers: Optional[Sequence[int]] = None,
                 now: Optional[float] = None) -> List[float]:
        """Elastic arrival seconds of ``workers`` (default: all), in the
        order given, as ``elastic_average_stacked`` takes them: a live
        worker's staleness, ``inf`` for a dead one."""
        stale = self.staleness(now)
        if workers is None:
            workers = range(self.n_workers)
        out = []
        for w in workers:
            s = stale[int(w)]
            out.append(s if s <= self.timeout_s else _INF)
        return out


def beat_on_chunk(writers: Sequence[HeartbeatWriter]):
    """A ``run_phase`` chunk hook that beats every writer (one launcher
    drives all the workers in its process)."""
    def hook(state, done):
        step = int(state.step.reshape(-1)[0])
        for w in writers:
            w.maybe_beat(step=step)
    return hook
