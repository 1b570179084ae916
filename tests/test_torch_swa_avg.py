"""The port's streaming average against JAX's.

The plain version (what the kernel is held to bit for bit on the card)
must be bitwise equal to ``repro/kernels/swa_avg/ref.py`` for f32 and bf16
accumulators; ``StreamingAverage``, ``ElasticAverage`` and
``elastic_average_stacked`` must fold the same models into the same bits,
masks, extensions and stragglers as the reference, in the scenarios of
``tests/test_elastic_averaging.py``. The CUDA kernel itself runs only on
the card (``chip_smoke.py``); here its wrapper must refuse CPU tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import averaging as javg  # noqa: E402
from repro.dist.config import DistConfig as JDist  # noqa: E402
from repro.kernels.swa_avg.ops import running_average_tree as jtree  # noqa: E402
from repro.kernels.swa_avg.ref import running_average_ref as jref  # noqa: E402
from repro_torch.core import averaging as tavg  # noqa: E402
from repro_torch.dist.config import DistConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.swa_avg import kernel as tkernel  # noqa: E402
from repro_torch.kernels.swa_avg import ops as tops  # noqa: E402
from repro_torch.kernels.swa_avg.ref import running_average_ref  # noqa: E402

INF = float("inf")


def _bits(x):
    a = np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                   np.asarray(x, np.float32))
    return a.view(np.int32)


def _assert_bitwise(t, j):
    np.testing.assert_array_equal(_bits(t), _bits(j))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [0, 1, 2, 7, 1000])
@pytest.mark.parametrize("size", [1, 8191, 8193])
def test_plain_version_bitwise_equal_to_jax(dtype, wdtype, n, size):
    rng = np.random.default_rng(size + n)
    a = rng.standard_normal(size).astype(np.float32) * 3
    w = rng.standard_normal(size).astype(np.float32)
    got = running_average_ref(torch.from_numpy(a).to(getattr(torch, dtype)),
                              torch.from_numpy(w).to(getattr(torch, wdtype)),
                              n)
    want = jref(jnp.asarray(a, dtype), jnp.asarray(w, wdtype), n)
    assert got.dtype == getattr(torch, dtype)
    _assert_bitwise(got, want)


def test_tree_op_and_inplace_bitwise():
    rng = np.random.default_rng(0)
    a = {"x": rng.standard_normal((4, 5)).astype(np.float32),
         "y": {"z": rng.standard_normal(7).astype(np.float32)}}
    w = {"x": rng.standard_normal((4, 5)).astype(np.float32),
         "y": {"z": rng.standard_normal(7).astype(np.float32)}}
    ta = {"x": torch.from_numpy(a["x"].copy()),
          "y": {"z": torch.from_numpy(a["y"]["z"].copy())}}
    tw = {"x": torch.from_numpy(w["x"]),
          "y": {"z": torch.from_numpy(w["y"]["z"])}}
    want = jtree(jax.tree_util.tree_map(jnp.asarray, a),
                 jax.tree_util.tree_map(jnp.asarray, w), 3.0,
                 impl="reference")
    got = tops.running_average_tree(ta, tw, 3.0)
    _assert_bitwise(got["x"], want["x"])
    _assert_bitwise(got["y"]["z"], want["y"]["z"])
    out = tops.running_average_tree(ta, tw, 3.0, inplace=True)
    assert out["x"] is ta["x"]
    _assert_bitwise(ta["x"], want["x"])


def test_kernel_on_cpu_raises_and_build_needs_nvcc(tmp_path, monkeypatch):
    a = torch.zeros(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkernel.running_average(a, a, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tops.running_average(a, a, 0, impl="kernel")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    tkernel._library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc"):
        tkernel.build()
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_library("swa_avg", [tkernel.SOURCE])


def _models(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [{"w": rng.standard_normal((3, 2)).astype(dtype),
             "b": rng.standard_normal(4).astype(dtype)} for _ in range(n)]


def _jtree(m):
    return {k: jnp.asarray(v) for k, v in m.items()}


def _ttree(m):
    return {k: torch.from_numpy(np.array(v)) for k, v in m.items()}


@pytest.mark.parametrize("n", [1, 2, 5])
def test_streaming_average_bitwise_equal_to_jax(n):
    models = _models(n)
    js, ts = javg.StreamingAverage(), tavg.StreamingAverage()
    for m in models:
        js.add(_jtree(m))
        ts.add(_ttree(m))
    assert ts.n == js.n == n
    for k in ("w", "b"):
        _assert_bitwise(ts.value()[k], js.value()[k])
        np.testing.assert_allclose(ts.value()[k].numpy(),
                                   np.mean([m[k] for m in models], 0),
                                   rtol=1e-6, atol=1e-6)


def test_streaming_average_copies_its_first_model_and_rejects_empty():
    ts = tavg.StreamingAverage()
    with pytest.raises(ValueError, match="no models"):
        ts.value()
    m = _ttree(_models(1)[0])
    ts.add(m)
    m["w"].add_(1.0)                   # the caller's tensors train on
    assert not torch.equal(ts.value()["w"], m["w"])
    with pytest.raises(ValueError, match="unknown kernel impl"):
        tavg.StreamingAverage(impl="pallas")


# (n_workers, deadline, backoff, max_ext, min_workers, arrivals)
SCENARIOS = {
    "all_on_time": (4, 10.0, 2.0, 2, 1, [1.0, 1.0, 1.0, 1.0]),
    "lost_worker": (4, 10.0, 2.0, 2, 1, [0.0, 0.0, 0.0, INF]),
    "straggler_dropped": (3, 5.0, 2.0, 2, 2, [1.0, 2.0, 500.0]),
    "backoff": (2, 5.0, 2.0, 2, 2, [1.0, 18.0]),
    "exact_deadline": (2, 5.0, 2.0, 2, 1, [5.0, INF]),
    "out_of_order": (3, 4.0, 3.0, 1, 3, [11.0, 0.5, 3.0]),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_elastic_average_stacked_matches_jax(name):
    n, deadline, backoff, ext, quorum, arrivals = SCENARIOS[name]
    models = _models(n, seed=len(name))
    jstack = {k: jnp.stack([m[k] for m in models]) for k in ("w", "b")}
    tstack = {k: torch.from_numpy(np.stack([m[k] for m in models]))
              for k in ("w", "b")}
    kw = dict(n_workers=n, elastic_deadline_s=deadline,
              elastic_backoff=backoff, elastic_max_extensions=ext,
              elastic_min_workers=quorum)
    javg_, jmask = javg.elastic_average_stacked(jstack, JDist(**kw),
                                                worker_arrivals=arrivals)
    tavg_, tmask = tavg.elastic_average_stacked(tstack, DistConfig(**kw),
                                                worker_arrivals=arrivals)
    assert tmask.tolist() == jmask.tolist()
    for k in ("w", "b"):
        _assert_bitwise(tavg_[k], javg_[k])


def test_elastic_bookkeeping_matches_jax():
    """Extensions, deadline and stragglers after the same rounds."""
    models = _models(3, seed=9)
    rounds = [(0, 1.0), (1, 2.0), (2, 50.0)]
    for quorum, ext in ((2, 2), (3, 2), (3, 0)):
        je = javg.ElasticAverage(3, 5.0, backoff=2.0, max_extensions=ext,
                                 min_workers=quorum)
        te = tavg.ElasticAverage(3, 5.0, backoff=2.0, max_extensions=ext,
                                 min_workers=quorum)
        outcomes = []
        for ea, tree in ((je, _jtree), (te, _ttree)):
            try:
                ea.collect([(w, tree(models[w]), t) for w, t in rounds])
                outcomes.append("ok")
            except (javg.ElasticAverageError,
                    tavg.ElasticAverageError) as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]
        assert (te.extensions_used, te.deadline, te.stragglers,
                te.mask.tolist()) == (je.extensions_used, je.deadline,
                                      je.stragglers, je.mask.tolist())


def test_elastic_validation():
    ea = tavg.ElasticAverage(2, deadline_s=10.0)
    m = _ttree(_models(1)[0])
    ea.submit(0, m, 0.0)
    with pytest.raises(ValueError, match="already reported"):
        ea.submit(0, m, 0.0)
    with pytest.raises(ValueError, match="out of range"):
        ea.submit(2, m, 0.0)
    with pytest.raises(ValueError, match="deadline_s"):
        tavg.ElasticAverage(2, deadline_s=0.0)
    with pytest.raises(ValueError, match="backoff"):
        tavg.ElasticAverage(2, deadline_s=1.0, backoff=0.5)
    with pytest.raises(ValueError, match="min_workers"):
        tavg.ElasticAverage(2, deadline_s=1.0, min_workers=3)
    dist = DistConfig(n_workers=2, elastic_deadline_s=1.0)
    stacked = {"w": torch.zeros(2, 3)}
    with pytest.raises(ValueError, match="3 entries for 2 workers"):
        tavg.elastic_average_stacked(stacked, dist,
                                     worker_arrivals=[0.0, 0.0, 0.0])
    ea = tavg.ElasticAverage(2, deadline_s=1.0, backoff=2.0,
                             max_extensions=2, min_workers=2)
    with pytest.raises(tavg.ElasticAverageError,
                       match=r"0/2 workers after 2 deadline extension"):
        ea.collect([(0, m, 99.0), (1, m, 99.0)])


def test_average_stacked_and_list_match_jax():
    models = _models(3, seed=4)
    jstack = {k: jnp.stack([m[k] for m in models]) for k in ("w", "b")}
    tstack = {k: torch.from_numpy(np.stack([m[k] for m in models]))
              for k in ("w", "b")}
    want = javg.average_stacked(jstack)
    got = tavg.average_stacked(tstack)
    got_list = tavg.average_list([_ttree(m) for m in models])
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
        assert torch.equal(got[k], got_list[k])


def test_recompute_bn_stats_weights_by_batch_size():
    """Twin of the reference's weighting: a short last batch counts by its
    size; an empty pass raises."""
    def stats_fn(params, batch):
        return {"mean": batch["x"].float().mean(0)}
    batches = [{"x": torch.full((4, 2), 1.0)}, {"x": torch.full((2, 2), 4.0)}]
    got = tavg.recompute_bn_stats(stats_fn, None, batches)
    np.testing.assert_allclose(got["mean"].numpy(), [2.0, 2.0])
    want = javg.recompute_bn_stats(
        lambda p, b: {"mean": jnp.mean(b["x"], 0)}, None,
        [{"x": jnp.full((4, 2), 1.0)}, {"x": jnp.full((2, 2), 4.0)}])
    np.testing.assert_allclose(got["mean"].numpy(), np.asarray(want["mean"]))
    with pytest.raises(ValueError, match="no batches"):
        tavg.recompute_bn_stats(stats_fn, None, [])
