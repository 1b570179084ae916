"""Live weight publishing in the port against the JAX package's, on the CPU:
requests in flight across a publish.

The mid-decode swap of ``tests/test_publish.py`` (attention KV, SSM state,
sliding window), with zamba2's per-unit SSM and shared-block caches added,
a swap on the paged int8 pool, and three publishes whose running average
folds in place while a request is pinned to an earlier one, each run
through the JAX engine and publisher and through the port's, on JAX
``Model.init`` params carried across with ``params_from_numpy`` and the
same numpy prompts: tokens, ``stats``, generations and publisher logs must
be identical, and the port's tokens equal its own single-request
``generate`` (or a single-generation engine) on the weights each request
is pinned to. The rest of ``tests/test_publish.py``, the publisher
scenarios of ``tests/test_resilience.py`` and ``launch.serve --follow``
are in ``test_torch_publisher.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve.publish as jpublish_mod  # noqa: E402
from repro.checkpoint import state as jstate  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.launch.serve import generate as jgenerate  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve.compiled import CompiledServingEngine as JCompiled  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro.train.loop import init_train_state as jinit_state  # noqa: E402
from repro_torch.checkpoint import state as tstate  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.optim.api import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import (CompiledServingEngine, Request,  # noqa: E402
                               WeightPublisher)
from repro_torch.train.loop import init_train_state as tinit_state  # noqa: E402

_SETUP = {}


def setup(arch):
    """(JAX model, port model, JAX params, port params): three weight
    generations from ``PRNGKey(0..2)``, as the reference test makes them,
    made once."""
    if arch not in _SETUP:
        jm = JModel(jreg.get_smoke_config(arch))
        tm = TModel(treg.get_smoke_config(arch))
        jps = [jm.init(jax.random.PRNGKey(k)) for k in range(3)]
        tps = [params_from_numpy(jax.device_get(p)) for p in jps]
        _SETUP[arch] = (jm, tm, jps, tps)
    return _SETUP[arch]


def prompts(cfg, lengths, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (L,)).astype(np.int32)
            for L in lengths]


class Side:
    """One package's engine, publisher, requests and generate."""

    def __init__(self, arch, jax_side: bool):
        jm, tm, jps, tps = setup(arch)
        self.jax = jax_side
        self.model, self.ps = (jm, jps) if jax_side else (tm, tps)
        self.cfg = tm.cfg

    def engine(self, params=None, **kw):
        cls = JCompiled if self.jax else CompiledServingEngine
        return cls(self.model, self.ps[0] if params is None else params,
                   **kw)

    def publisher(self, *args, **kw):
        cls = jpublish_mod.WeightPublisher if self.jax else WeightPublisher
        return cls(*args, **kw)

    def request(self, rid, prompt, max_new_tokens, **kw):
        if self.jax:
            return JRequest(rid=rid, prompt=jnp.asarray(prompt),
                            max_new_tokens=max_new_tokens, **kw)
        return Request(rid=rid, prompt=torch.from_numpy(prompt),
                       max_new_tokens=max_new_tokens, **kw)

    def generate(self, params, prompt, n_new):
        if self.jax:
            out, _ = jgenerate(self.model, params,
                               jnp.asarray(prompt)[None], n_new)
        else:
            out, _ = tserve.generate(self.model, params,
                                     torch.from_numpy(prompt)[None], n_new)
        return [int(t) for t in np.asarray(out)[0]]

    def scaled(self, params, c):
        if self.jax:
            return jax.tree_util.tree_map(lambda x: x * c, params)
        return tree_map(lambda x: x * c, params)

    def leaves(self, tree):
        if self.jax:
            return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]
        return [x.numpy().copy() for x in tree_leaves(tree)]

    def state(self, trees, step):
        """A TrainState of ``trees`` (phase-2 shaped, a leading worker
        axis, when there are several)."""
        if self.jax:
            if len(trees) == 1:
                return jinit_state({"params": trees[0], "state": {}},
                                   opt_state={}, step=step)
            stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                             *trees)
            return jinit_state({"params": stacked, "state": {}},
                               opt_state={}, step=0)._replace(
                step=jnp.full((len(trees),), step, jnp.int32))
        if len(trees) == 1:
            return tinit_state({"params": trees[0], "state": {}},
                               opt_state={}, step=step)
        stacked = tree_map(lambda *xs: torch.stack(xs), *trees)
        return tinit_state({"params": stacked, "state": {}}, opt_state={},
                           step=0)._replace(
            step=torch.full((len(trees),), step, dtype=torch.int64))

    def ckpt(self):
        return jstate if self.jax else tstate


def both(arch, scenario):
    """``scenario(side)`` on the JAX package and on the port."""
    return scenario(Side(arch, True)), scenario(Side(arch, False))


def check_stats(jeng, teng):
    assert teng.stats == jeng.stats
    assert teng.stats["decode_transfers"] == teng.stats["decode_calls"]


def drain(eng):
    while eng.active or eng.waiting:
        eng.step()


def _mid_decode_swap(side, **kw):
    """A is mid-decode when generation 1 lands; B is admitted after it."""
    pa, pb = prompts(side.cfg, [9, 7])
    eng = side.engine(max_batch=2, max_seq=64, decode_block=4, **kw)
    a = side.request(0, pa, 12)
    b = side.request(1, pb, 12)
    eng.submit(a)
    eng.step()                                   # A is mid-decode (4 of 12)
    assert eng.publish(side.ps[1]) is True       # the other buffer is free
    assert eng.generation == 1
    eng.submit(b)                                # admitted at generation 1
    drain(eng)
    return eng, a, b, (pa, pb)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "mamba2-2.7b",
                                  "gemma3-1b", "zamba2-7b"])
def test_token_exact_under_mid_decode_swap(arch):
    """Attention KV, SSM state, sliding window and the hybrid's per-unit
    SSM and shared-block caches: A finishes exact on its admission weights,
    B on the new generation, as in the JAX engine, and the generations
    overlapped in the dual block."""
    (jeng, ja, jb, _), (teng, a, b, (pa, pb)) = both(arch, _mid_decode_swap)
    assert (a.generated, b.generated) == (ja.generated, jb.generated)
    assert a.done and b.done
    assert (a.generation, b.generation) == (ja.generation, jb.generation) \
        == (0, 1)
    check_stats(jeng, teng)
    port = Side(arch, False)
    want_a = port.generate(port.ps[0], pa, 12)
    assert a.generated == want_a, "in-flight request changed under a swap"
    assert b.generated == port.generate(port.ps[1], pb, 12)
    assert want_a != port.generate(port.ps[1], pa, 12), \
        "the two generations give A the same tokens: the check is blind"
    st = teng.stats
    assert st["dual_decode_calls"] > 0 and st["publish_swaps"] == 1
    assert teng.kv_layout == ("dense" if arch == "mamba2-2.7b" else "paged")


def test_mid_decode_swap_on_the_paged_int8_pool():
    """The same swap on the int8 page pool: each request equals a
    single-generation int8 engine's on its pinned weights."""
    kw = dict(kv_layout="paged", kv_cache_dtype="int8", page_size=8)
    (jeng, ja, jb, _), (teng, a, b, (pa, pb)) = both(
        "internlm2-1.8b", lambda s: _mid_decode_swap(s, **kw))
    assert (a.generated, b.generated) == (ja.generated, jb.generated)
    check_stats(jeng, teng)
    assert teng.stats["dual_decode_calls"] > 0
    port = Side("internlm2-1.8b", False)
    for req, p, k in ((a, pa, 0), (b, pb, 1)):
        eng = port.engine(port.ps[k], max_batch=2, max_seq=64,
                          decode_block=4, **kw)
        assert eng.run([port.request(0, p, 12)])[0] == req.generated
    assert len(teng._free_pages) == teng.n_pages - 1
