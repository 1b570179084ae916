"""DistConfig, single-process part: twin of ``repro/dist/config.py``.

The port runs one process on one card. What it keeps of the reference's
distribution surface is the phase-2 worker count and the elastic phase-3
averaging knobs (``elastic_deadline_s`` > 0 turns the strict phase-3
barrier into a deadline; ``elastic_backoff`` / ``elastic_max_extensions``
grow it while fewer than ``elastic_min_workers`` reported -- see
``repro_torch.core.averaging.ElasticAverage``), with their validation and
flags, and the heartbeat liveness knobs (``heartbeat_dir`` enables the
file beacons of ``repro_torch.dist.heartbeat``; ``heartbeat_interval_s``
is the least spacing between beats; ``heartbeat_timeout_s`` the beacon
staleness that declares a worker dead, 0 deriving it, see
``resolved_heartbeat_timeout``). Mesh geometry, the sharded engine and
multi-host layout come with the distribution item (ROADMAP A13b); their
flags are not registered, so passing one is an error.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class DistConfig:
    n_workers: int = 1
    elastic_deadline_s: float = 0.0
    elastic_backoff: float = 2.0
    elastic_max_extensions: int = 2
    elastic_min_workers: int = 1
    # heartbeat liveness ("" = off: elastic arrivals stay caller-supplied)
    heartbeat_dir: str = ""
    heartbeat_interval_s: float = 0.0
    heartbeat_timeout_s: float = 0.0

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")
        if self.elastic_deadline_s < 0:
            raise ValueError("elastic_deadline_s must be >= 0")
        if self.elastic_backoff < 1.0:
            raise ValueError("elastic_backoff must be >= 1 (the deadline "
                             "never shrinks)")
        if self.elastic_max_extensions < 0:
            raise ValueError("elastic_max_extensions must be >= 0")
        if not (1 <= self.elastic_min_workers <= self.n_workers):
            raise ValueError(
                f"elastic_min_workers must be in [1, n_workers="
                f"{self.n_workers}], got {self.elastic_min_workers}")
        if self.heartbeat_interval_s < 0:
            raise ValueError("heartbeat_interval_s must be >= 0")
        if self.heartbeat_timeout_s < 0:
            raise ValueError("heartbeat_timeout_s must be >= 0")
        if (self.heartbeat_timeout_s > 0 and self.heartbeat_interval_s > 0
                and self.heartbeat_timeout_s < self.heartbeat_interval_s):
            raise ValueError(
                f"heartbeat_timeout_s ({self.heartbeat_timeout_s}) must be "
                f">= heartbeat_interval_s ({self.heartbeat_interval_s}): a "
                f"timeout shorter than the beat spacing declares every "
                f"worker dead between beats")

    @property
    def elastic(self) -> bool:
        return self.elastic_deadline_s > 0

    @property
    def heartbeats(self) -> bool:
        return bool(self.heartbeat_dir)

    @property
    def resolved_heartbeat_timeout(self) -> float:
        """Liveness timeout in seconds: the explicit knob, else 3 beat
        intervals (one missed beat is a hiccup, three a death), else 30 s
        where every chunk boundary beats."""
        if self.heartbeat_timeout_s > 0:
            return self.heartbeat_timeout_s
        if self.heartbeat_interval_s > 0:
            return 3.0 * self.heartbeat_interval_s
        return 30.0

    @classmethod
    def from_args(cls, args, n_workers_default: int = 1) -> "DistConfig":
        """From an argparse namespace produced by ``add_dist_args``."""
        kw = {f.name: f.default for f in dataclasses.fields(cls)}
        kw["n_workers"] = (args.workers if args.workers is not None
                           else n_workers_default)
        if args.elastic_deadline is not None:
            kw["elastic_deadline_s"] = args.elastic_deadline
        if args.elastic_backoff is not None:
            kw["elastic_backoff"] = args.elastic_backoff
        if args.elastic_min_workers is not None:
            kw["elastic_min_workers"] = args.elastic_min_workers
        if args.heartbeat_dir is not None:
            kw["heartbeat_dir"] = args.heartbeat_dir
        if args.heartbeat_interval is not None:
            kw["heartbeat_interval_s"] = args.heartbeat_interval
        if args.heartbeat_timeout is not None:
            kw["heartbeat_timeout_s"] = args.heartbeat_timeout
        return cls(**kw)


def add_dist_args(parser) -> None:
    """The single-process DistConfig flags. Defaults are None so that
    ``from_args`` can tell 'not passed' from 'passed the default'."""
    g = parser.add_argument_group("distribution (DistConfig, one process)")
    g.add_argument("--workers", type=int, default=None,
                   help="SWAP phase-2 worker count (DistConfig.n_workers)")
    g.add_argument("--elastic-deadline", type=float, default=None,
                   metavar="SECONDS",
                   help="elastic phase-3 averaging: fold whichever workers "
                        "report within this deadline (0 = strict barrier)")
    g.add_argument("--elastic-backoff", type=float, default=None,
                   help="deadline growth factor while fewer than "
                        "--elastic-min-workers reported (default 2.0)")
    g.add_argument("--elastic-min-workers", type=int, default=None,
                   help="fewest live workers an elastic average may fold "
                        "(all-late past the backed-off deadline is an error)")
    g.add_argument("--heartbeat-dir", default=None, metavar="DIR",
                   help="directory for per-worker heartbeat beacons "
                        "(repro_torch.dist.heartbeat); real liveness in "
                        "place of simulated elastic arrivals")
    g.add_argument("--heartbeat-interval", type=float, default=None,
                   metavar="SECONDS",
                   help="least spacing between heartbeats (0 = beat at "
                        "every chunk boundary)")
    g.add_argument("--heartbeat-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="beacon staleness that declares a worker dead "
                        "(0 = 3x the interval, or 30 s)")
