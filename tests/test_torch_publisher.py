"""Live weight publishing in the port against the JAX package's, on the CPU:
the engine's publish queue, the publisher and the follower.

The rest of ``tests/test_publish.py`` (deferred, superseded, stale and
misshapen publishes; the ``WeightPublisher`` epoch hook over a
``StreamingAverage``, its rollbacks; the ``PublishFollower``) and the
three publisher scenarios of ``tests/test_resilience.py`` (each
package's ``FaultPlan().failing_engine()``, a duck-typed engine, drives
its own publisher) run through the JAX package and the port on the same
params and prompts: tokens, ``stats``, generations, publisher logs and
``failures`` identical. Then ``launch.serve --follow`` seeded from one
generation already written.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve.publish as jpublish_mod  # noqa: E402
import repro.testing.faults as jfaults  # noqa: E402
import repro_torch.serve.publish as tpublish_mod  # noqa: E402
import repro_torch.testing.faults as tfaults  # noqa: E402
from repro_torch.checkpoint import state as tstate  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.optim.api import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve import PublishFollower, WeightPublisher  # noqa: E402
from test_torch_publish import (Side, both, check_stats, drain,  # noqa: E402
                                prompts)


def test_publish_deferred_until_pinned_buffer_drains():
    """Both buffers hold live generations: a third publish defers, then
    applies once the pinned generation drains; the next admission serves
    it."""
    def run(side):
        cfg = side.cfg
        ps = prompts(cfg, [9, 7, 5])
        eng = side.engine(max_batch=2, max_seq=64, decode_block=4)
        long_req = side.request(0, ps[0], 16)
        eng.submit(long_req)
        eng.step()                                # pins buffer 0 (gen 0)
        assert eng.publish(side.ps[1]) is True    # buffer 1 <- gen 1
        mid = side.request(1, ps[1], 4)
        eng.submit(mid)                           # pins buffer 1 (gen 1)
        assert eng.publish(side.ps[2]) is False   # buffer 0 busy
        assert eng.generation == 1
        while not long_req.done:
            eng.step()
        assert eng.generation == 2                # the drain freed buffer 0
        late = side.request(2, ps[2], 6)
        eng.submit(late)
        drain(eng)
        return eng, [long_req, mid, late], ps

    (jeng, jreqs, _), (teng, reqs, ps) = both("internlm2-1.8b", run)
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [r.generation for r in reqs] == [r.generation for r in jreqs] \
        == [0, 1, 2]
    check_stats(jeng, teng)
    assert teng.stats["publish_swaps"] == 2
    port = Side("internlm2-1.8b", False)
    assert reqs[2].generated == port.generate(port.ps[2], ps[2], 6)
    assert reqs[0].generated == port.generate(port.ps[0], ps[0], 16)
    assert reqs[1].generated == port.generate(port.ps[1], ps[1], 4)


def test_publish_superseded_and_stale():
    """Only the newest deferred publish survives; a stale generation is
    refused outright; generation numbers are never reused."""
    def run(side):
        eng = side.engine(max_batch=2, max_seq=64, decode_block=4)
        req = side.request(0, prompts(side.cfg, [9])[0], 12)
        eng.submit(req)
        eng.step()                                # pins buffer 0
        assert eng.publish(side.ps[1]) is True    # gen 1 live in buffer 1
        assert eng.publish(side.ps[2]) is False   # deferred
        assert eng.publish(side.ps[1], generation=1) is None   # stale
        p3 = side.scaled(side.ps[2], 2)
        assert eng.publish(p3) is False           # supersedes p2
        assert eng.stats["publish_superseded"] == 1
        drain(eng)
        eng._admit()                              # retry point for pending
        assert eng.generation == 3
        return eng, req, side.leaves(eng.params), side.leaves(p3)

    (jeng, jreq, jgot, _), (teng, req, got, want) = both("internlm2-1.8b",
                                                         run)
    assert req.generated == jreq.generated
    check_stats(jeng, teng)
    assert len(got) == len(want) == len(jgot)
    for g, w, j in zip(got, want, jgot):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)


def test_publish_shape_mismatch_raises():
    for side in (Side("internlm2-1.8b", True), Side("internlm2-1.8b", False)):
        eng = side.engine(max_batch=2, max_seq=64)
        if side.jax:
            bad = jax.tree_util.tree_map(
                lambda x: jnp.zeros(x.shape + (1,), x.dtype), side.ps[0])
        else:
            bad = tree_map(lambda x: torch.zeros(x.shape + (1,),
                                                 dtype=x.dtype), side.ps[0])
        with pytest.raises(ValueError, match="different model config"):
            eng.publish(bad)


def test_weight_publisher_requires_sink():
    for cls in (jpublish_mod.WeightPublisher, WeightPublisher):
        with pytest.raises(ValueError, match="somewhere to publish"):
            cls()


def _consts(side, values, shape=(3,)):
    if side.jax:
        return [{"k": jnp.full(shape, float(v), jnp.float32)}
                for v in values]
    return [{"k": torch.full(shape, float(v), dtype=torch.float32)}
            for v in values]


def test_weight_publisher_epoch_hook_folds_running_average(tmp_path):
    """Two epoch boundaries: generation g is the streaming mean of the
    first g across-worker means, in both packages."""
    def run(side):
        d = str(tmp_path / ("jax" if side.jax else "port"))
        w = _consts(side, range(4))
        pub = side.publisher(directory=d, ensemble=True)
        pub.on_epoch(side.state([w[0], w[1]], 10), 10)
        pub.on_epoch(side.state([w[2], w[3]], 20), 20)
        pubs = side.ckpt().list_publishes(d)
        gens = [side.leaves(side.ckpt().load_publish(p["path"], w[0]))[0]
                for p in pubs]
        meta = [(p["generation"], p["step"], p["meta"]["folds"])
                for p in pubs]
        return pub.log, meta, gens

    (jlog, jmeta, jgens), (log, meta, gens) = both("internlm2-1.8b", run)
    assert log == jlog
    assert meta == jmeta == [(1, 10, 1), (2, 20, 2)]
    for g, j in zip(gens, jgens):
        np.testing.assert_array_equal(g, j)
    np.testing.assert_allclose(gens[0], 0.5)
    np.testing.assert_allclose(gens[1], (0.5 + 2.5) / 2)


def test_weight_publisher_every_skips_boundaries(tmp_path):
    def run(side):
        d = str(tmp_path / ("jax" if side.jax else "port"))
        w = _consts(side, [1], (2,))[0]
        pub = side.publisher(directory=d, ensemble=False, every=2)
        got = [pub.on_epoch(side.state([w], 5), 5),
               pub.on_epoch(side.state([w], 9), 9)]
        return got, len(side.ckpt().list_publishes(d)), pub.log

    want, got = both("internlm2-1.8b", run)
    assert got == want == ([None, 1], 1, [{"generation": 1, "step": 9,
                                           "folds": 1}])


def test_publisher_rolls_back_generation_on_snapshot_failure(tmp_path,
                                                             monkeypatch):
    """A failed snapshot propagates without taking a generation number;
    the retry lands as generation 1."""
    def run(side):
        d = str(tmp_path / ("jax" if side.jax else "port"))
        mod = jpublish_mod if side.jax else tpublish_mod
        w = _consts(side, [1], (2,))[0]
        pub = side.publisher(directory=d, ensemble=False)
        with monkeypatch.context() as m:
            m.setattr(mod, "save_publish", lambda *a, **k: (_ for _ in ())
                      .throw(OSError("disk full")))
            with pytest.raises(OSError):
                pub.publish(w, step=5)
        assert pub.generation == 0 and pub.log == []
        gen = pub.publish(w, step=5)
        return gen, [p["generation"] for p in side.ckpt().list_publishes(d)], \
            pub.log

    want, got = both("internlm2-1.8b", run)
    assert got == want == (1, [1], [{"generation": 1, "step": 5,
                                     "folds": 0}])


def test_publisher_rolls_back_when_all_engines_reject_stale():
    """Every engine refuses the generation as stale: the publisher's
    counter does not move and nothing is logged."""
    def run(side):
        eng = side.engine(max_batch=2, max_seq=64)
        assert eng.publish(side.ps[1], generation=5) is True
        pub = side.publisher([eng], ensemble=False)
        got = pub.publish(side.ps[2], step=9)
        return got, pub.generation, pub.log, eng.generation, eng

    (*want, jeng), (*got, teng) = both("internlm2-1.8b", run)
    assert got == want == [0, 0, [], 5]
    check_stats(jeng, teng)


def test_publisher_engine_and_follower_roundtrip(tmp_path):
    """The engine's swap and the follower in another process see the same
    generation; the snapshot is written first."""
    def run(side):
        d = str(tmp_path / ("jax" if side.jax else "port"))
        eng = side.engine(max_batch=2, max_seq=64)
        pub = side.publisher([eng], directory=d, ensemble=False)
        follow_cls = (jpublish_mod.PublishFollower if side.jax
                      else PublishFollower)
        follower = follow_cls(d, template=side.ps[0])
        assert follower.poll() is None            # nothing published yet
        gen = pub.publish(side.ps[1], step=17)
        assert gen == 1 and eng.generation == 1
        got_gen, got = follower.poll()
        assert follower.poll() is None            # already consumed
        latest = side.ckpt().find_latest_publish(d)
        return (got_gen, latest["generation"], latest["step"], pub.log,
                side.leaves(got), side.leaves(side.ps[1]), eng)

    (*want, jl, _, jeng), (*got, tl, tp1, teng) = both("internlm2-1.8b", run)
    assert got == want and got[:3] == [1, 1, 17]
    for g, j, p in zip(tl, jl, tp1):
        np.testing.assert_array_equal(g, j)
        np.testing.assert_array_equal(g, p)
    check_stats(jeng, teng)


def _flaky_publish(side, n_fail, **kw):
    plan = (jfaults if side.jax else tfaults).FaultPlan().fail_publishes(
        n_fail)
    engine = plan.failing_engine()
    sleeps = []
    pub = side.publisher([engine], sleep=sleeps.append, **kw)
    return pub, engine, sleeps


def test_publisher_retries_through_injected_failures():
    def run(side):
        pub, engine, sleeps = _flaky_publish(side, 2, max_retries=2,
                                             retry_backoff_s=0.1)
        gen = pub.publish(_consts(side, [1], (2,))[0], step=7)
        return gen, pub.generation, engine.delivered, sleeps, pub.log

    want, got = both("internlm2-1.8b", run)
    assert got == want
    assert got[:3] == (1, 1, [1])
    assert got[3] == pytest.approx([0.1, 0.2])   # exponential backoff
    assert got[4] == [{"generation": 1, "step": 7, "folds": 0}]


def test_publisher_skip_records_failure_and_recovers():
    """Delivery fails past the retry budget: ``on_failure="skip"`` records
    it, the counter does not move, and the next publish lands as
    generation 1."""
    def run(side):
        pub, engine, _ = _flaky_publish(side, 3, max_retries=1,
                                        retry_backoff_s=0.0,
                                        on_failure="skip")
        params = _consts(side, [1], (2,))[0]
        with pytest.warns(RuntimeWarning, match="skipping"):
            first = pub.publish(params, step=3)
        counts = (pub.generation, list(pub.log))
        second = pub.publish(params, step=4)
        return first, counts, pub.failures, second, engine.delivered

    want, got = both("internlm2-1.8b", run)
    assert got == want
    first, counts, failures, second, delivered = got
    assert first == 0 and counts == (0, [])
    assert len(failures) == 1 and failures[0]["step"] == 3
    assert failures[0]["attempts"] == 2
    assert second == 1 and delivered == [1]


def test_publisher_raise_is_default_and_preserves_generation():
    def run(side):
        pub, _, _ = _flaky_publish(side, 1)
        with pytest.raises(RuntimeError, match="injected publish failure"):
            pub.publish(_consts(side, [1], (2,))[0])
        return pub.generation, pub.log

    want, got = both("internlm2-1.8b", run)
    assert got == want == (0, [])


def test_three_publishes_fold_in_place_under_a_pinned_request():
    """``on_epoch`` folds into the ``StreamingAverage``'s own tensors in
    place; the engine copies each generation into its buffers, so a
    request pinned to generation 1 stays exact while generations 2 and 3
    are folded and published, the third publish reuses buffer 0 without
    writing into the caller's construction params, and every request
    equals ``generate`` on its generation's weights."""
    def run(side):
        ps = prompts(side.cfg, [9, 7, 6, 8], seed=4)
        eng = side.engine(max_batch=2, max_seq=64, decode_block=4)
        pub = side.publisher([eng], ensemble=False)
        folds = [side.ps[1], side.ps[2], side.ps[1]]
        gens, reqs, snaps = [], [], {0: side.ps[0]}

        def epoch(i):
            gens.append(pub.on_epoch(side.state([folds[i]], 10 * (i + 1)),
                                     10 * (i + 1)))
            snaps[gens[-1]] = side.leaves(pub.average.value())

        def submit(rid, n):
            reqs.append(side.request(rid, ps[rid], n))
            eng.submit(reqs[-1])

        submit(0, 10)
        eng.step()
        epoch(0)                       # gen 1: applied, buffer 1
        submit(1, 20)                  # pinned to gen 1
        eng.step()
        epoch(1)                       # gen 2: deferred (0 pins buffer 0)
        while not reqs[0].done:
            eng.step()                 # gen 2 applies into buffer 0
        submit(2, 8)                   # pinned to gen 2
        epoch(2)                       # gen 3: deferred (1 pins buffer 1)
        eng.step()
        while not reqs[1].done:
            eng.step()
        submit(3, 6)                   # gen 3
        drain(eng)
        return eng, pub, gens, reqs, snaps, ps

    p0 = [x.clone() for x in tree_leaves(Side("internlm2-1.8b", False).ps[0])]
    (jeng, jpub, jgens, jreqs, _, _), (teng, pub, gens, reqs, snaps, ps) = \
        both("internlm2-1.8b", run)
    assert gens == jgens == [1, 2, 3] and pub.log == jpub.log
    assert [r.generated for r in reqs] == [r.generated for r in jreqs]
    assert [r.generation for r in reqs] == [r.generation for r in jreqs] \
        == [0, 1, 2, 3]
    check_stats(jeng, teng)
    st = teng.stats
    assert st["publish_swaps"] == 3 and st["dual_decode_calls"] > 0
    # the caller's generation-0 tensors are untouched, the engine's
    # buffers share no storage with them nor with the running average
    port = Side("internlm2-1.8b", False)
    for before, now in zip(p0, tree_leaves(port.ps[0])):
        assert torch.equal(before, now)
    theirs = {x.data_ptr() for x in tree_leaves(port.ps[0])
              + tree_leaves(pub.average.value())}
    for buf in teng._buffers:
        assert not theirs & {x.data_ptr() for x in tree_leaves(buf)}
    template = port.ps[0]
    for req, p in zip(reqs, ps):
        leaves = iter(torch.from_numpy(x) for x in (
            snaps[req.generation] if req.generation else
            [x.numpy() for x in tree_leaves(template)]))
        params = _rebuild(template, leaves)
        assert req.generated == port.generate(params, p,
                                              req.max_new_tokens), req.rid


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def test_follow_mode_serves_a_seeded_generation(tmp_path, capsys):
    """``launch.serve --follow``: seeded from the one generation already in
    the directory, it serves a request stream until the follow timeout and
    reports every request on that generation, one block read a decode
    call."""
    _, tp = tserve.build_model("internlm2-1.8b", full=False, seed=5,
                               device="cpu")
    tstate.save_publish(str(tmp_path), 1, 40, tp)
    report = tserve.main([
        "--device", "cpu", "--follow", str(tmp_path), "--follow-timeout",
        "0.5", "--batch", "2", "--prompt-len", "8", "--new-tokens", "6",
        "--decode-block", "4"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "seeded from publish generation 1"
    assert report["pickups"] == 0 and list(report["per_generation"]) == [1]
    e = report["per_generation"][1]
    assert e["requests"] >= 2 and e["tokens"] == 6 * e["requests"]
    st = report["stats"]
    assert st["publish_swaps"] == 1 and st["dual_decode_calls"] == 0
    assert st["decode_transfers"] == st["decode_calls"] > 0
    assert out[1] == "follow mode done: 0 generation pickups"
    assert out[2] == (f"  generation 1: {e['requests']} requests, "
                      f"{e['tokens']} tokens")
    assert out[3] == (f"decode_calls={st['decode_calls']} "
                      f"decode_transfers={st['decode_transfers']} "
                      f"publish_swaps=1 dual_decode_calls=0")
