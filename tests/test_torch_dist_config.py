"""The port's DistConfig (``repro_torch.dist.config``) and process layout
(``repro_torch.dist.mesh``, ``repro_torch.launch.mesh``), held against the
reference's ``repro.dist.config`` on the same inputs: the cases of the
reference's ``tests/test_dist_config.py``, each run through both packages
(the reference's config is plain Python up to ``make_mesh``), with a
``ProcessMesh`` where the reference builds a ``jax`` mesh, and a JSON that
the reference's ``DistConfig.to_json`` writes loaded unchanged.

The port has one field the reference lacks, ``backend`` (the transport
that ``jax.distributed`` picks for itself), and its flag
``--dist-backend``; ``_fields`` compares everything else."""
import argparse
import json
import warnings

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

from repro.dist import config as jconfig  # noqa: E402
from repro.dist.config import DistConfig as JDist  # noqa: E402
from repro_torch.dist.config import (DistConfig, add_dist_args,  # noqa: E402
                                     parse_mesh, resolve_dist)
from repro_torch.dist.mesh import ProcessMesh  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh, make_worker_mesh  # noqa: E402,E501

WORKER_DATA = ((4, 2), ("worker", "data"))
MULTI = dict(coordinator="localhost:9999", num_processes=4, process_id=2)


def _fields(cfg):
    """Every field of a config as JSON values, the port's ``backend``
    left out (the reference has none)."""
    data = json.loads(cfg.to_json())
    data.pop("backend", None)
    return data


def _same(port, ref):
    assert _fields(port) == _fields(ref)
    assert port.backend == ""


# ---------------------------------------------------------------------------
# parse_mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", [
    "worker:2,data:2,model:2", "worker:8,data:2", " worker : 2 , data:4 ",
    "pod:2,worker:2,data:2,model:2",
    "4", "4x2", "2x2x2", "2x2x2x2", "4X2", "",
])
def test_parse_mesh_matches_the_reference(spec):
    """Both syntaxes and the rank defaults: (shape, axes) as the
    reference parses them."""
    assert parse_mesh(spec) == jconfig.parse_mesh(spec)


def test_parse_mesh_named_and_bare_values():
    """The reference's expected values, so that both agreeing on a wrong
    parse would still fail."""
    assert parse_mesh("worker:2,data:2,model:2") == (
        (2, 2, 2), ("worker", "data", "model"))
    assert parse_mesh("4x2") == ((4, 2), ("data", "model"))
    assert parse_mesh("2x2x2x2") == (
        (2, 2, 2, 2), ("pod", "worker", "data", "model"))
    assert parse_mesh("") == ((), ())


@pytest.mark.parametrize("spec,match", [
    ("2x2x2x2x2", "named form"), ("worker:,data:2", "name:size"),
    (":2", "name:size"), ("worker:x", "invalid literal"),
    ("2xq", "invalid literal"),
])
def test_parse_mesh_errors_match_the_reference(spec, match):
    for parse in (parse_mesh, jconfig.parse_mesh):
        with pytest.raises(ValueError, match=match):
            parse(spec)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(mesh_shape=(2, 2), mesh_axes=("worker",)), "equal rank"),
    (dict(phase2_engine="pmap"), "phase2_engine"),
    (dict(n_workers=0), "n_workers"),
    (dict(elastic_deadline_s=-1.0), "elastic_deadline_s"),
    (dict(elastic_backoff=0.5), "backoff"),
    (dict(elastic_max_extensions=-1), "elastic_max_extensions"),
    (dict(n_workers=2, elastic_min_workers=3), "elastic_min_workers"),
    (dict(num_processes=0), "num_processes"),
    (dict(num_processes=2), "coordinator"),
    (dict(num_processes=2, process_id=2, coordinator="localhost:9999"),
     "process_id"),
    (dict(process_id=-1), "process_id"),
    (dict(heartbeat_interval_s=-1.0), "heartbeat_interval_s"),
    (dict(heartbeat_timeout_s=-1.0), "heartbeat_timeout_s"),
    (dict(heartbeat_interval_s=2.0, heartbeat_timeout_s=1.0),
     "heartbeat_timeout_s"),
])
def test_validation_rejects_what_the_reference_rejects(kw, match):
    for cls in (DistConfig, JDist):
        with pytest.raises(ValueError, match=match):
            cls(**kw)


@pytest.mark.parametrize("kw", [
    dict(), dict(mesh_shape=(4, 2), mesh_axes=("worker", "data"),
                 n_workers=4, elastic_deadline_s=30.0),
    dict(n_workers=2, elastic_min_workers=2, elastic_backoff=1.0,
         elastic_max_extensions=0),
    dict(MULTI), dict(heartbeat_dir="/hb", heartbeat_interval_s=2.0,
                      heartbeat_timeout_s=2.0),
    dict(phase2_engine="sharded", donate_state=False),
])
def test_validation_accepts_what_the_reference_accepts(kw):
    port, ref = DistConfig(**kw), JDist(**kw)
    _same(port, ref)
    assert port.elastic == ref.elastic
    assert port.heartbeats == ref.heartbeats
    assert port.resolved_heartbeat_timeout == ref.resolved_heartbeat_timeout


def test_validation_rejects_an_unknown_backend():
    """``backend`` is the port's own field: no reference to hold it to."""
    with pytest.raises(ValueError, match="backend"):
        DistConfig(backend="mpi")


@pytest.mark.parametrize("axes", [("data", "worker"), ("model", "worker")])
def test_worker_axis_must_be_outermost(axes):
    for cls in (DistConfig, JDist):
        with pytest.raises(ValueError, match="outermost"):
            cls(mesh_shape=(2, 4), mesh_axes=axes).make_mesh()


# ---------------------------------------------------------------------------
# derived properties / engine and backend resolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mesh_shape=(4, 2), mesh_axes=("worker", "data"), n_workers=4),
    dict(mesh_shape=(4, 2), mesh_axes=("data", "model")),
    dict(phase2_engine="vmap", mesh_shape=(4, 2),
         mesh_axes=("worker", "data"), n_workers=4),
    dict(phase2_engine="sharded"),
])
def test_resolved_engine_matches_the_reference(kw):
    assert DistConfig(**kw).resolved_engine() == \
        JDist(**kw).resolved_engine()
    assert DistConfig(**kw).has_worker_axis == JDist(**kw).has_worker_axis


def test_resolved_engine_values():
    assert DistConfig().resolved_engine() == "vmap"
    assert DistConfig(mesh_shape=(4, 2), mesh_axes=("worker", "data"),
                      n_workers=4).resolved_engine() == "sharded"


@pytest.mark.parametrize("layout", [WORKER_DATA, ((4, 2), ("data", "model"))])
def test_resolved_engine_prefers_runtime_mesh(layout):
    """A runtime layout decides 'auto' over the config's own axes, in both
    (the reference reads only ``axis_names`` of the mesh it is given)."""
    mesh = ProcessMesh(*layout)
    want = "sharded" if "worker" in layout[1] else "vmap"
    assert DistConfig().resolved_engine(mesh) == want
    assert JDist().resolved_engine(mesh) == want


@pytest.mark.parametrize("kw", [dict(), dict(MULTI),
                                dict(MULTI, process_id=0),
                                dict(coordinator="h:1", num_processes=1)])
def test_data_shard_matches_the_reference(kw):
    port, ref = DistConfig(**kw), JDist(**kw)
    assert (port.data_shard, port.multihost) == (ref.data_shard,
                                                 ref.multihost)
    assert DistConfig(**MULTI).data_shard == (2, 4)


@pytest.mark.parametrize("backend,device,want", [
    ("", "cuda", "nccl"), ("", "cpu", "gloo"), ("gloo", "cuda", "gloo")])
def test_resolved_backend(backend, device, want):
    assert DistConfig(backend=backend).resolved_backend(device) == want


def test_initialize_is_a_no_op_for_one_process():
    assert DistConfig().initialize(device="cpu") is None
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# the process layout
# ---------------------------------------------------------------------------


def test_process_mesh_blocks():
    mesh = DistConfig(mesh_shape=(2, 2), mesh_axes=("worker", "data"),
                      n_workers=4).make_mesh()
    assert mesh.size == 4 and mesh.n_blocks == 2 and mesh.block_size == 2
    assert [mesh.block_ranks(b) for b in range(2)] == [[0, 1], [2, 3]]
    assert [mesh.owned_workers(r, 4) for r in range(4)] == \
        [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert [mesh.owner(w, 4) for w in range(4)] == [0, 0, 2, 2]
    assert [mesh.data_index(r) for r in range(4)] == [0, 1, 0, 1]
    with pytest.raises(ValueError, match="do not split"):
        mesh.owned_workers(0, 3)


@pytest.mark.parametrize("layout", [
    WORKER_DATA, ((2, 2, 2), ("worker", "data", "model")),
    ((2, 2, 1, 1), ("pod", "worker", "data", "model")),
])
def test_from_mesh_matches_the_reference(layout):
    """``from_mesh`` reads the same geometry off a layout in both."""
    mesh = ProcessMesh(*layout)
    _same(DistConfig.from_mesh(mesh), JDist.from_mesh(mesh))
    _same(DistConfig.from_mesh(mesh, elastic_deadline_s=5.0),
          JDist.from_mesh(mesh, elastic_deadline_s=5.0))


def test_meshes_over_the_processes_that_exist():
    assert make_worker_mesh(1).shape == {"worker": 1, "data": 1, "model": 1}
    assert make_host_mesh(4).shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="do not split"):
        make_worker_mesh(2)


# ---------------------------------------------------------------------------
# JSON round-trip
# ---------------------------------------------------------------------------


def test_json_roundtrip(tmp_path):
    cfg = DistConfig(mesh_shape=(4, 2), mesh_axes=("worker", "data"),
                     n_workers=4, elastic_deadline_s=30.0,
                     elastic_min_workers=2, donate_state=False,
                     backend="gloo")
    assert DistConfig.from_json(cfg.to_json()) == cfg
    path = str(tmp_path / "dist.json")
    cfg.to_json(path)
    assert DistConfig.from_json(path) == cfg


@pytest.mark.parametrize("bad", [{"n_workres": 4}, {"mesh": "4x2"}])
def test_from_json_rejects_unknown_keys(bad):
    for cls in (DistConfig, JDist):
        with pytest.raises(ValueError, match="unknown DistConfig keys"):
            cls.from_json(json.dumps(bad))


def test_the_port_has_every_reference_field():
    assert set(_fields(DistConfig())) == set(_fields(JDist()))


def test_reference_json_loads_unchanged(tmp_path):
    """A file the reference's ``DistConfig.to_json`` wrote: every one of
    its fields, the same values in the port."""
    ref = JDist(mesh_shape=(2, 2, 1), mesh_axes=("worker", "data", "model"),
                n_workers=2, phase2_engine="sharded", donate_state=False,
                elastic_deadline_s=30.0, elastic_backoff=3.0,
                elastic_max_extensions=1, elastic_min_workers=2,
                coordinator="10.0.0.1:1234", num_processes=4, process_id=3,
                heartbeat_dir="/hb", heartbeat_interval_s=2.0,
                heartbeat_timeout_s=9.0)
    path = str(tmp_path / "ref.json")
    ref.to_json(path)
    got = DistConfig.from_json(path)
    _same(got, ref)
    for key, value in json.loads(ref.to_json()).items():
        want = tuple(value) if isinstance(value, list) else value
        assert getattr(got, key) == want, key


# ---------------------------------------------------------------------------
# CLI flag surface: both parsers on the same argv
# ---------------------------------------------------------------------------


def _parse(argv, add=add_dist_args):
    ap = argparse.ArgumentParser()
    add(ap)
    return ap.parse_args(argv)


def _from_args_both(argv, **kw):
    port = DistConfig.from_args(_parse(argv), **kw)
    ref = JDist.from_args(_parse(argv, jconfig.add_dist_args), **kw)
    _same(port, ref)
    return port


@pytest.mark.parametrize("argv", [
    ["--mesh", "worker:4,data:2", "--workers", "4",
     "--elastic-deadline", "30", "--elastic-min-workers", "2"],
    ["--mesh", "2x2x2", "--workers", "2", "--phase2-engine", "vmap",
     "--elastic-backoff", "3"],
    ["--coordinator", "127.0.0.1:1", "--num-processes", "8",
     "--process-id", "5", "--phase2-engine", "sharded"],
    ["--heartbeat-dir", "/hb", "--heartbeat-interval", "2",
     "--heartbeat-timeout", "7", "--workers", "3"],
    ["--dump-dist-config", "x.json", "--mesh", ""],
])
def test_from_args_flags_match_the_reference(argv):
    _from_args_both(argv)


def test_from_args_flag_values():
    cfg = _from_args_both(["--mesh", "worker:4,data:2", "--workers", "4",
                           "--elastic-deadline", "30",
                           "--elastic-min-workers", "2"])
    assert (cfg.mesh_shape, cfg.mesh_axes) == ((4, 2), ("worker", "data"))
    assert (cfg.n_workers, cfg.elastic_deadline_s,
            cfg.elastic_min_workers) == (4, 30.0, 2)


def test_from_args_backend_flag():
    """``--dist-backend`` is the port's own flag."""
    cfg = DistConfig.from_args(_parse(["--dist-backend", "gloo"]))
    assert cfg == DistConfig(backend="gloo")


@pytest.mark.parametrize("n_workers_default", [1, 4])
def test_from_args_defaults(n_workers_default):
    cfg = _from_args_both([], n_workers_default=n_workers_default)
    assert cfg == DistConfig(n_workers=n_workers_default)


@pytest.mark.parametrize("argv", [
    ["--elastic-deadline", "99"],
    ["--elastic-deadline", "99", "--workers", "8", "--mesh", "worker:8"],
    [],
])
def test_from_args_file_plus_override(tmp_path, argv):
    """Passed flags override the --dist-config file, which the reference
    wrote; flags left at their parser default defer to it. The same in
    both."""
    path = str(tmp_path / "dist.json")
    JDist(mesh_shape=(4, 2), mesh_axes=("worker", "data"), n_workers=4,
          elastic_deadline_s=10.0).to_json(path)
    cfg = _from_args_both(["--dist-config", path] + argv,
                          n_workers_default=2)
    assert cfg.n_workers == (8 if "--workers" in argv else 4)
    assert cfg.elastic_deadline_s == (99.0 if argv else 10.0)


# ---------------------------------------------------------------------------
# resolve_dist: the deprecated mesh= shim
# ---------------------------------------------------------------------------


def test_resolve_dist_mesh_shim_warns_and_works():
    mesh = ProcessMesh(*WORKER_DATA)
    with pytest.warns(DeprecationWarning, match="mesh=.*deprecated"):
        dist, out_mesh = resolve_dist(None, mesh, caller="SWAP")
    with pytest.warns(DeprecationWarning, match="mesh=.*deprecated"):
        jdist, jmesh = jconfig.resolve_dist(None, mesh, caller="SWAP")
    assert out_mesh is mesh and jmesh is mesh   # the layout used as is
    _same(dist, jdist)
    assert (dist.mesh_shape, dist.n_workers) == ((4, 2), 4)


def test_resolve_dist_rejects_both():
    mesh = ProcessMesh(*WORKER_DATA)
    with pytest.raises(ValueError, match="not both"):
        resolve_dist(DistConfig(), mesh, caller="SWAP")
    with pytest.raises(ValueError, match="not both"):
        jconfig.resolve_dist(JDist(), mesh, caller="SWAP")


def test_resolve_dist_neither():
    dist, mesh = resolve_dist()
    jdist, jmesh = jconfig.resolve_dist()
    _same(dist, jdist)
    assert dist == DistConfig() and mesh is None and jmesh is None


def test_resolve_dist_passes_a_config_through():
    """dist= alone: the config as given and its own layout (the reference
    builds a jax mesh there; only the config is compared)."""
    cfg = DistConfig(mesh_shape=(2, 1), mesh_axes=("worker", "data"),
                     n_workers=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        dist, mesh = resolve_dist(cfg)
    assert dist is cfg and mesh.shape == {"worker": 2, "data": 1}


def test_swap_mesh_kwarg_still_works():
    """The SWAP constructor's mesh= spelling works behind the
    DeprecationWarning shim."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import (OptimizerConfig, PhaseConfig,
                                          ScheduleConfig, SWAPConfig)
    from repro_torch.core.adapters import LMAdapter
    from repro_torch.core.swap import SWAP
    from repro_torch.data.pipeline import Loader

    cfg = registry.get_smoke_config("internlm2-1.8b")
    train = {"tokens": torch.zeros((64, 8), dtype=torch.int32).numpy(),
             "labels": torch.zeros((64, 8), dtype=torch.int32).numpy()}
    adapter = LMAdapter(cfg, OptimizerConfig(kind="sgd"))
    swap_cfg = SWAPConfig(
        n_workers=4,
        phase1=PhaseConfig(batch_size=16, max_steps=1,
                           schedule=ScheduleConfig(kind="const")),
        phase2=PhaseConfig(batch_size=16, max_steps=1,
                           schedule=ScheduleConfig(kind="const")))
    mesh = ProcessMesh(*WORKER_DATA)
    with pytest.warns(DeprecationWarning):
        s = SWAP(adapter, swap_cfg, train, Loader(train, 32), mesh=mesh)
    assert s.mesh is mesh
    assert s.dist.n_workers == 4
    assert s.dist.resolved_engine(s.mesh) == "sharded"


# ---------------------------------------------------------------------------
# the cache rules, moved from serve/compiled.py
# ---------------------------------------------------------------------------


def _cache_archs():
    from repro_torch.configs import registry
    return [a for a in registry.list_archs()
            if registry.get_smoke_config(a).family != "cnn"]


@pytest.mark.parametrize("arch", _cache_archs())
@pytest.mark.parametrize("paged", [False, True])
def test_cache_rules_match_the_reference(arch, paged):
    """``cache_batch_dim`` / ``page_pool_dim`` give the reference's dims on
    every leaf path of every arch's cache, dense and paged, and those dims
    hold the slots (or the pages)."""
    from repro.dist.sharding import cache_batch_dim as jbatch
    from repro.dist.sharding import page_pool_dim as jpage
    from repro_torch.configs import registry
    from repro_torch.dist.sharding import cache_batch_dim, page_pool_dim
    from repro_torch.models.model import Model
    from repro_torch.serve.compiled import _flatten

    model = Model(registry.get_smoke_config(arch))
    cache = model.empty_cache(3, 16, "cpu",
                              page_pool=(5, 8) if paged else None)
    leaves = _flatten(cache)
    assert leaves
    for path, leaf in leaves.items():
        assert page_pool_dim(path) == jpage(path), path
        assert cache_batch_dim(path) == jbatch(path), path
        pd = page_pool_dim(path)
        dim = cache_batch_dim(path) if pd is None else pd
        assert leaf.shape[dim] == (3 if pd is None else 5), (path, leaf.shape)
