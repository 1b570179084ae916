"""DistConfig: twin of ``repro/dist/config.py`` on ``torch.distributed``.

One frozen dataclass describes the distribution surface:

  * the process layout -- ``mesh_shape`` / ``mesh_axes`` (pure data, so the
    config is hashable and JSON round-trippable; ``make_mesh()`` builds the
    runtime ``repro_torch.dist.mesh.ProcessMesh`` over the processes that
    exist, one process a card);
  * the phase-2 engine -- ``phase2_engine``: "sharded" runs on each process
    only the workers its block of the ``worker`` axis owns, with no
    collective outside that block; "vmap" runs every worker on every
    process (the single-process path, the oracle of the tests); "auto"
    picks "sharded" iff the layout has a worker axis;
  * ``donate_state`` -- the reference's buffer donation policy. It has no
    meaning under PyTorch (the port's steps update the state in place
    either way) and is kept so that a JSON written by the reference loads
    and round-trips unchanged;
  * elastic averaging -- ``elastic_deadline_s`` > 0 turns the strict
    phase-3 barrier into a deadline; ``elastic_backoff`` /
    ``elastic_max_extensions`` grow it while fewer than
    ``elastic_min_workers`` reported (``repro_torch.core.averaging.
    ElasticAverage``);
  * the multi-process layout -- ``coordinator`` ("host:port"),
    ``num_processes`` and ``process_id`` feed
    ``torch.distributed.init_process_group``, and ``backend`` ("nccl",
    "gloo", or "" for NCCL on the card and gloo on the CPU) is the
    transport, which ``jax.distributed`` picks for itself; ``initialize()``
    is the launcher's first call;
  * heartbeat liveness -- ``heartbeat_dir`` enables the file beacons of
    ``repro_torch.dist.heartbeat``; ``heartbeat_interval_s`` is the least
    spacing between beats, ``heartbeat_timeout_s`` the staleness that
    declares a worker dead (0 derives it, see
    ``resolved_heartbeat_timeout``).

The flag surface (``add_dist_args`` / ``DistConfig.from_args``) and the
programmatic one expose the same knobs, and ``to_json`` / ``from_json``
round-trip a config through a file, so that a launch can be replayed.
``resolve_dist`` is the ``mesh=`` shim: a caller that passes a layout
object instead of a config gets a ``DeprecationWarning``.
"""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

_ENGINES = ("auto", "sharded", "vmap")
_BACKENDS = ("", "nccl", "gloo")

# rank -> default axis names for bare "2x2x2"-style mesh specs
_DEFAULT_AXES = {
    1: ("data",),
    2: ("data", "model"),
    3: ("worker", "data", "model"),
    4: ("pod", "worker", "data", "model"),
}

# how long a process waits for the others at start-up and in a collective
# before the run fails instead of hanging
DEFAULT_TIMEOUT_S = 300.0


def parse_mesh(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Parse a ``--mesh`` spec into (shape, axes).

    Two syntaxes:
      * named:  ``worker:2,data:2,model:2``
      * bare:   ``2x2x2`` -- axes default by rank (1d: data; 2d: data,model;
        3d: worker,data,model; 4d: pod,worker,data,model)
    """
    spec = spec.strip()
    if not spec:
        return (), ()
    if ":" in spec:
        shape, axes = [], []
        for part in spec.split(","):
            name, _, size = part.partition(":")
            if not name.strip() or not size.strip():
                raise ValueError(f"bad mesh axis {part!r} in {spec!r} "
                                 f"(want name:size)")
            axes.append(name.strip())
            shape.append(int(size))
        return tuple(shape), tuple(axes)
    sizes = tuple(int(t) for t in spec.lower().split("x"))
    if len(sizes) not in _DEFAULT_AXES:
        raise ValueError(
            f"bare mesh spec {spec!r} has rank {len(sizes)}; use the named "
            f"form (e.g. 'worker:2,data:4') for ranks outside "
            f"{sorted(_DEFAULT_AXES)}")
    return sizes, _DEFAULT_AXES[len(sizes)]


@dataclass(frozen=True)
class DistConfig:
    """The distribution config (see the module docstring)."""

    # process layout -- () means no layout: the single-process path
    mesh_shape: Tuple[int, ...] = ()
    mesh_axes: Tuple[str, ...] = ()
    n_workers: int = 1

    # phase-2 engine; donation has no meaning here (module docstring)
    phase2_engine: str = "auto"        # "auto" | "sharded" | "vmap"
    donate_state: bool = True

    # elastic averaging (0 = strict: phase 3 waits for every worker)
    elastic_deadline_s: float = 0.0
    elastic_backoff: float = 2.0
    elastic_max_extensions: int = 2
    elastic_min_workers: int = 1

    # multi-process (torch.distributed)
    coordinator: str = ""              # "host:port"; "" = one process
    num_processes: int = 1
    process_id: int = 0

    # heartbeat liveness ("" = off: elastic arrivals stay caller-supplied)
    heartbeat_dir: str = ""
    heartbeat_interval_s: float = 0.0
    heartbeat_timeout_s: float = 0.0

    # the torch.distributed backend: "" = NCCL on the card, gloo on the CPU
    backend: str = ""

    def __post_init__(self):
        if len(self.mesh_shape) != len(self.mesh_axes):
            raise ValueError(
                f"mesh_shape {self.mesh_shape} and mesh_axes "
                f"{self.mesh_axes} must have equal rank")
        if self.phase2_engine not in _ENGINES:
            raise ValueError(f"phase2_engine must be one of {_ENGINES}, "
                             f"got {self.phase2_engine!r}")
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
        if self.num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if not (0 <= self.process_id < self.num_processes):
            raise ValueError(
                f"process_id {self.process_id} out of range for "
                f"num_processes {self.num_processes}")
        if self.num_processes > 1 and not self.coordinator:
            raise ValueError("multi-process (num_processes > 1) needs a "
                             "coordinator address ('host:port')")
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
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got "
                             f"{self.backend!r}")

    # ------------------------------------------------------------------
    # derived properties
    # ------------------------------------------------------------------

    @property
    def elastic(self) -> bool:
        return self.elastic_deadline_s > 0

    @property
    def multihost(self) -> bool:
        return self.num_processes > 1

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

    @property
    def has_worker_axis(self) -> bool:
        return "worker" in self.mesh_axes

    @property
    def data_shard(self) -> Optional[Tuple[int, int]]:
        """Per-process data shard for ``repro_torch.data.pipeline.Loader``:
        ``(process_id, num_processes)``, so that each process gathers only
        its slice of every phase-1 batch; None for one process."""
        return (self.process_id, self.num_processes) if self.multihost \
            else None

    def resolved_engine(self, mesh=None) -> str:
        """'sharded' or 'vmap'. 'auto' resolves to 'sharded' exactly when a
        layout with a worker axis is in play."""
        if self.phase2_engine != "auto":
            return self.phase2_engine
        has_worker = ("worker" in mesh.axis_names) if mesh is not None \
            else self.has_worker_axis
        return "sharded" if has_worker else "vmap"

    def resolved_backend(self, device: str = "cuda") -> str:
        """The backend ``initialize`` uses: the explicit field, else NCCL
        for a run on the card and gloo for one on the CPU. Two processes
        that share one card need ``backend="gloo"``: NCCL refuses them."""
        if self.backend:
            return self.backend
        return "nccl" if device == "cuda" else "gloo"

    # ------------------------------------------------------------------
    # runtime construction
    # ------------------------------------------------------------------

    def make_mesh(self):
        """The runtime ``ProcessMesh`` from ``mesh_shape``/``mesh_axes``
        over the processes that exist, or None when no layout is set. The
        worker axis (when present) must be outermost (after an optional
        pod axis), so that worker w owns a contiguous block of ranks (the
        audit's contract, ``dist.sharding.
        assert_no_cross_worker_collectives``)."""
        if not self.mesh_shape:
            return None
        if "worker" in self.mesh_axes and self.mesh_axes[0] != "worker" \
                and self.mesh_axes[0] != "pod":
            raise ValueError(
                f"the worker axis must be outermost (after an optional pod "
                f"axis) so each worker owns a contiguous block of ranks; "
                f"got axes {self.mesh_axes}")
        from repro_torch.dist.mesh import ProcessMesh
        return ProcessMesh(self.mesh_shape, self.mesh_axes)

    def initialize(self, device: str = "cuda",
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[str]:
        """``torch.distributed.init_process_group`` for a multi-process
        run; a no-op (returning None) for one process. Process
        ``process_id`` joins ``num_processes`` at ``tcp://coordinator``
        on ``resolved_backend(device)`` (returned), with ``timeout_s`` as
        the limit of the start-up and of every collective, so that a
        process that never arrives fails the run instead of hanging it.
        On the card each process takes ``cuda:{process_id % cards}``:
        one process a card, or several on one card where there is one.
        The launchers call it first thing."""
        if not self.multihost:
            return None
        import torch
        import torch.distributed as tdist
        backend = self.resolved_backend(device)
        if device == "cuda":
            torch.cuda.set_device(self.process_id % torch.cuda.device_count())
        tdist.init_process_group(
            backend, init_method=f"tcp://{self.coordinator}",
            world_size=self.num_processes, rank=self.process_id,
            timeout=datetime.timedelta(seconds=timeout_s))
        return backend

    @classmethod
    def from_mesh(cls, mesh, **overrides) -> "DistConfig":
        """A DistConfig from a layout's geometry (the ``mesh=`` shim)."""
        axes = tuple(mesh.axis_names)
        shape = tuple(int(mesh.shape[a]) for a in axes)
        kw = dict(mesh_shape=shape, mesh_axes=axes)
        if "worker" in axes:
            kw["n_workers"] = int(mesh.shape["worker"])
        kw.update(overrides)
        return cls(**kw)

    # ------------------------------------------------------------------
    # JSON round trip
    # ------------------------------------------------------------------

    def to_json(self, path: Optional[str] = None) -> str:
        """Serialize to a JSON string; also write it to ``path`` if given."""
        text = json.dumps(dataclasses.asdict(self), indent=1)
        if path:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    @classmethod
    def from_json(cls, src: str) -> "DistConfig":
        """Load from a JSON string or a path to a JSON file. Unknown keys
        are rejected (a mistyped knob must not silently default); a key
        left out, such as ``backend`` in a file the reference wrote, takes
        its default."""
        if os.path.exists(src):
            with open(src) as f:
                src = f.read()
        data = json.loads(src)
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - fields
        if unknown:
            raise ValueError(f"unknown DistConfig keys {sorted(unknown)}; "
                             f"known: {sorted(fields)}")
        for key in ("mesh_shape", "mesh_axes"):
            if key in data:
                data[key] = tuple(data[key])
        return cls(**data)

    # ------------------------------------------------------------------
    # CLI flag surface (launch.train, experiments.train_lm_swap)
    # ------------------------------------------------------------------

    @classmethod
    def from_args(cls, args, n_workers_default: int = 1) -> "DistConfig":
        """From an argparse namespace produced by ``add_dist_args``.

        ``--dist-config FILE`` loads a base config; flags that were passed
        override it (a flag left at its parser default defers to the
        file)."""
        base = cls.from_json(args.dist_config) if args.dist_config else cls()
        kw = {f.name: getattr(base, f.name) for f in dataclasses.fields(cls)}
        if args.mesh is not None:
            kw["mesh_shape"], kw["mesh_axes"] = parse_mesh(args.mesh)
        if args.workers is not None:
            kw["n_workers"] = args.workers
        elif not args.dist_config:
            kw["n_workers"] = n_workers_default
        flags = (("phase2_engine", "phase2_engine"),
                 ("elastic_deadline", "elastic_deadline_s"),
                 ("elastic_backoff", "elastic_backoff"),
                 ("elastic_min_workers", "elastic_min_workers"),
                 ("coordinator", "coordinator"),
                 ("num_processes", "num_processes"),
                 ("process_id", "process_id"),
                 ("heartbeat_dir", "heartbeat_dir"),
                 ("heartbeat_interval", "heartbeat_interval_s"),
                 ("heartbeat_timeout", "heartbeat_timeout_s"),
                 ("dist_backend", "backend"))
        for flag, field in flags:
            value = getattr(args, flag)
            if value is not None:
                kw[field] = value
        return cls(**kw)


def add_dist_args(parser) -> None:
    """Install the DistConfig flag surface on an argparse parser. Defaults
    are None, so that ``DistConfig.from_args`` can tell 'not passed' from
    'passed the default' (a file config's values stay right)."""
    g = parser.add_argument_group(
        "distribution (repro_torch.dist.DistConfig; the same knobs as the "
        "programmatic surface)")
    g.add_argument("--mesh", default=None, metavar="SPEC",
                   help="process layout: 'worker:2,data:2' or '2x2x1' "
                        "(bare rank 3 means worker,data,model), one "
                        "process a card; omit for one process")
    g.add_argument("--workers", type=int, default=None,
                   help="SWAP phase-2 worker count (DistConfig.n_workers)")
    g.add_argument("--phase2-engine", default=None,
                   choices=["auto", "sharded", "vmap"],
                   help="phase 2: each process runs only its block's "
                        "workers (sharded), every process runs every "
                        "worker (vmap, the oracle), or auto (sharded iff "
                        "the layout has a worker axis)")
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
    g.add_argument("--dist-config", default="", metavar="FILE",
                   help="load a DistConfig JSON file "
                        "(DistConfig.from_json); passed flags override it")
    g.add_argument("--dump-dist-config", default="", metavar="FILE",
                   help="write the resolved DistConfig to FILE "
                        "(DistConfig.to_json) and continue")
    g.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="torch.distributed rendezvous address "
                        "(multi-process)")
    g.add_argument("--num-processes", type=int, default=None,
                   help="total processes (multi-process)")
    g.add_argument("--process-id", type=int, default=None,
                   help="this process's rank (multi-process)")
    g.add_argument("--dist-backend", default=None,
                   choices=["nccl", "gloo"],
                   help="torch.distributed backend (default: nccl on the "
                        "card, gloo on the CPU; gloo where processes share "
                        "a card)")
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


def resolve_dist(dist: Optional[DistConfig] = None, mesh=None, *,
                 caller: str = "caller"):
    """Resolve the (dist=, mesh=) pair into ``(DistConfig, layout or
    None)``.

    ``mesh=`` (a ``ProcessMesh``) is the deprecated spelling: it still
    works (the layout is used as it is, and a DistConfig is derived from
    its geometry) but warns. Passing both is an error: a layout that
    disagrees with the config would silently win."""
    if mesh is not None and dist is not None:
        raise ValueError(
            f"{caller}: pass dist= (DistConfig) or the deprecated mesh=, "
            f"not both")
    if mesh is not None:
        warnings.warn(
            f"{caller}(mesh=...) is deprecated; pass "
            f"dist=DistConfig.from_mesh(mesh) (or a hand-built DistConfig) "
            f"instead.", DeprecationWarning, stacklevel=3)
        return DistConfig.from_mesh(mesh), mesh
    if dist is None:
        return DistConfig(), None
    return dist, dist.make_mesh()
