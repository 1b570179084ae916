"""DistConfig, single-process part: twin of ``repro/dist/config.py``.

The port runs one process on one card. What it keeps of the reference's
distribution surface is the phase-2 worker count and the elastic phase-3
averaging knobs (``elastic_deadline_s`` > 0 turns the strict phase-3
barrier into a deadline; ``elastic_backoff`` / ``elastic_max_extensions``
grow it while fewer than ``elastic_min_workers`` reported -- see
``repro_torch.core.averaging.ElasticAverage``), with their validation and
flags. Mesh geometry, the sharded engine, multi-host layout and heartbeats
come with the distribution item (ROADMAP A13); their flags are not
registered, so passing one is an error.
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

    @property
    def elastic(self) -> bool:
        return self.elastic_deadline_s > 0

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
