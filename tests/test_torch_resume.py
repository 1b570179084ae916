"""Checkpoint and resume on the port: twin of ``tests/test_resume.py``, and
the same contract across the two packages.

Interrupting a SWAP run mid-phase-1 or mid-phase-2 and resuming it must
give the uninterrupted run's results bitwise: the final params, the BN
state, the metric logs of the steps after the resume, every accuracy. The
interruption is made as the reference's test makes it: run with periodic
snapshots, copy the checkpoint directory and delete every snapshot written
after the cut (what a killed process leaves), then start a fresh SWAP with
``resume=True``. On the tiny LM of the reference's test and on the
cifar-cnn smoke config.

Across the packages: the same TrainState gives the same snapshot bytes
(and crc32) from ``repro.checkpoint.state.save_train_state`` and from the
port's, file names included; a JAX snapshot cut mid-phase-2 resumes in the
port and ends within ``tests/test_torch_swap.py``'s tolerances of the JAX
uninterrupted run (1e-4; accuracies 1/512); a port snapshot loads in JAX's
``load_train_state``.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.checkpoint import state as jstate  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core.adapters import LMAdapter as JAdapter  # noqa: E402
from repro.core.swap import SWAP as JSWAP  # noqa: E402
from repro.data.pipeline import Loader as JLoader  # noqa: E402
from repro.train import loop as jloop  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.checkpoint.state import (  # noqa: E402
    Checkpointer, checkpoint_workers, find_resume_point, load_train_state,
    save_train_state, shrink_worker_axis,
)
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import CNNAdapter  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.swap import SWAP  # noqa: E402
from repro_torch.data.pipeline import (Loader, make_gmm_images,  # noqa: E402
                                       make_markov_lm)
from repro_torch.optim.api import tree_leaves, tree_map  # noqa: E402
from repro_torch.train.loop import (init_train_state,  # noqa: E402
                                    stack_train_state)

TOL = 1e-4
TINY = dict(name="tiny-lm", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=32,
            attention="gqa", dtype="float32", remat=False, scan_layers=False)


def _state_leaves(state):
    """A TrainState's tensors, in field order."""
    out = []
    for x in state:
        out += tree_leaves(x) if isinstance(x, dict) else (
            list(x) if isinstance(x, tuple) else [x])
    return out


def _assert_leaves_equal(la, lb):
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _assert_trees_equal(a, b):
    _assert_leaves_equal(tree_leaves(a), tree_leaves(b))


def _assert_states_equal(a, b):
    _assert_leaves_equal(_state_leaves(a), _state_leaves(b))


def _swap_cfg(b, ckpt_dir: str):
    # phase 1: batch 32 over 128 samples -> spe 4, 8 steps = chunks [4, 4],
    #   snapshots at steps 4 and 8 (checkpoint_every=4)
    # phase 2: batch 32 -> spe 4, 6 steps = chunks [4, 2], snapshot at 4
    return b.SWAPConfig(
        n_workers=2,
        phase1=b.PhaseConfig(batch_size=32, max_steps=8,
                             schedule=b.ScheduleConfig(kind="const",
                                                       peak_lr=0.1)),
        phase2=b.PhaseConfig(batch_size=32, max_steps=6,
                             schedule=b.ScheduleConfig(kind="const",
                                                       peak_lr=0.05)),
        bn_recompute_batch_size=64, bn_recompute_batches=2, seed=0,
        checkpoint_dir=ckpt_dir, checkpoint_every=4)


@pytest.fixture(scope="module")
def data():
    d = make_markov_lm(0, vocab=32, n_train=128, n_test=64, seq_len=16)
    return ({"tokens": d["train_tokens"], "labels": d["train_labels"]},
            {"tokens": d["test_tokens"], "labels": d["test_labels"]})


@pytest.fixture(scope="module")
def task(data):
    train, test = data
    adapter = LMAdapter(tbase.ModelConfig(**TINY),
                        tbase.OptimizerConfig(kind="sgd"))
    return adapter, train, Loader(test, 64)


def _run(task, ckpt_dir, resume=False, **over):
    adapter, train, test_loader = task
    cfg = dataclasses.replace(_swap_cfg(tbase, ckpt_dir), **over)
    return SWAP(adapter, cfg, train, test_loader).run(
        torch.Generator().manual_seed(0), resume=resume)


@pytest.fixture(scope="module")
def uninterrupted(task, tmp_path_factory):
    ckpt_dir = str(tmp_path_factory.mktemp("ckpts") / "run")
    return ckpt_dir, _run(task, ckpt_dir)


def _interrupt_dir(src: str, dst: str, keep) -> str:
    """Copy a checkpoint dir, keeping only snapshots written before the
    simulated kill (``keep(filename) -> bool``)."""
    shutil.copytree(src, dst)
    for name in os.listdir(dst):
        if not keep(name):
            os.remove(os.path.join(dst, name))
    return dst


def _keep_mid_p1(n):
    return n.startswith("phase1-step00000004")


def _keep_mid_p2(n):
    return (n.startswith("phase1-") or n.startswith("phase1_final-")
            or n.startswith("phase2-step00000004"))


@pytest.fixture(scope="module")
def jax_uninterrupted(data, tmp_path_factory):
    """The same run in the JAX package (its own init: the port's phase-2
    resume replaces the init with phase1_final's state)."""
    train, test = data
    ckpt_dir = str(tmp_path_factory.mktemp("jax_ckpts") / "run")
    adapter = JAdapter(jbase.ModelConfig(**TINY),
                       jbase.OptimizerConfig(kind="sgd"))
    res = JSWAP(adapter, _swap_cfg(jbase, ckpt_dir), train,
                JLoader(test, 64)).run(jax.random.PRNGKey(0))
    return ckpt_dir, res


def test_uninterrupted_run_writes_expected_snapshots(uninterrupted,
                                                     jax_uninterrupted):
    ckpt_dir, _ = uninterrupted
    names = sorted(os.listdir(ckpt_dir))
    assert "phase1-step00000004.msgpack" in names
    assert "phase1-step00000008.msgpack" in names
    assert "phase1_final-step00000008.msgpack" in names
    assert "phase2-step00000004.msgpack" in names
    assert names == sorted(os.listdir(jax_uninterrupted[0]))


def test_resume_mid_phase1_is_bitwise_identical(task, uninterrupted,
                                                tmp_path):
    src, res_a = uninterrupted
    dst = _interrupt_dir(src, str(tmp_path / "mid_p1"), keep=_keep_mid_p1)
    res_b = _run(task, dst, resume=True)

    _assert_trees_equal(res_a["final_bundle"]["params"],
                        res_b["final_bundle"]["params"])
    _assert_trees_equal(res_a["stacked_params"], res_b["stacked_params"])
    # the resumed process re-executes steps 4..7; its metric log must
    # equal the tail of the uninterrupted log bitwise
    tail_a = [e for e in res_a["phase1_log"] if e["step"] >= 4]
    assert res_b["phase1_log"] == tail_a
    assert res_b["phase1_steps"] == res_a["phase1_steps"]
    assert res_b["after_avg_test_acc"] == res_a["after_avg_test_acc"]


def test_resume_mid_phase2_is_bitwise_identical(task, uninterrupted,
                                                tmp_path):
    src, res_a = uninterrupted
    dst = _interrupt_dir(src, str(tmp_path / "mid_p2"), keep=_keep_mid_p2)
    res_b = _run(task, dst, resume=True)

    _assert_trees_equal(res_a["final_bundle"]["params"],
                        res_b["final_bundle"]["params"])
    _assert_trees_equal(res_a["stacked_params"], res_b["stacked_params"])
    # phase 1 was not re-run: its summary metrics come from phase1_final
    assert res_b["phase1_log"] == []
    assert res_b["phase1_steps"] == res_a["phase1_steps"]
    assert res_b["phase1_test_acc"] == res_a["phase1_test_acc"]
    assert res_b["worker_test_accs"] == res_a["worker_test_accs"]
    assert res_b["after_avg_test_acc"] == res_a["after_avg_test_acc"]


def test_resume_phase2_with_fewer_workers(task, uninterrupted, tmp_path):
    """A 2-worker phase-2 snapshot resumed by a 1-worker run keeps worker
    0's trajectory and averages only it (the reference's tolerances; the
    port runs the workers one after another, so it is bitwise here)."""
    src, res_a = uninterrupted
    dst = _interrupt_dir(src, str(tmp_path / "shrink"), keep=_keep_mid_p2)
    res_b = _run(task, dst, resume=True, n_workers=1)

    surviving = tree_map(lambda a: a[:1], res_a["stacked_params"])
    for a, b in zip(tree_leaves(surviving),
                    tree_leaves(res_b["stacked_params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7)
    np.testing.assert_allclose(res_b["worker_test_accs"],
                               res_a["worker_test_accs"][:1], atol=1e-3)


def test_resume_phase2_with_more_workers_refused(task, uninterrupted,
                                                 tmp_path):
    """Growing the ensemble on resume is refused: cloned workers would
    share a trajectory, breaking the independence the average relies on."""
    src, _ = uninterrupted
    dst = _interrupt_dir(src, str(tmp_path / "grow"), keep=_keep_mid_p2)
    with pytest.raises(ValueError, match="cloned workers"):
        _run(task, dst, resume=True, n_workers=3)


# ---------------------------------------------------------------------------
# the CNN+BatchNorm path (smoke config): BN state included
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cnn(tmp_path_factory):
    d = make_gmm_images(0, n_classes=10, image_size=16, n_train=256,
                        n_test=256, noise=2.0)
    train = {"images": d["train_images"], "labels": d["train_labels"]}
    task = (CNNAdapter(treg.get_smoke_config("cifar-cnn"),
                       tbase.OptimizerConfig(kind="sgd")),
            train, Loader({"images": d["test_images"],
                           "labels": d["test_labels"]}, 128))
    # phase 1: batch 64 over 256 -> spe 4, 8 steps; phase 2: W 2, 6 steps
    over = dict(phase1=tbase.PhaseConfig(
        batch_size=64, max_steps=8, schedule=tbase.ScheduleConfig(
            kind="warmup_linear", peak_lr=0.4, warmup_steps=2,
            total_steps=8)),
        phase2=tbase.PhaseConfig(batch_size=64, max_steps=6,
                                 schedule=tbase.ScheduleConfig(
                                     kind="const", peak_lr=0.05)),
        bn_recompute_batch_size=128)
    ckpt_dir = str(tmp_path_factory.mktemp("cnn_ckpts") / "run")
    return task, over, ckpt_dir, _run(task, ckpt_dir, **over)


def _assert_same_run(res_a, res_b, phase1_tail):
    for key in ("final_bundle", "phase1_bundle"):
        _assert_trees_equal(res_a[key], res_b[key])   # params and BN state
    _assert_trees_equal(res_a["stacked_params"], res_b["stacked_params"])
    assert res_b["phase1_log"] == [e for e in res_a["phase1_log"]
                                   if e["step"] >= phase1_tail]
    for key in ("phase1_steps", "phase2_steps", "phase1_test_acc",
                "phase1_train_acc", "worker_test_accs",
                "before_avg_test_acc", "after_avg_test_acc"):
        assert res_b[key] == res_a[key], key


@pytest.mark.parametrize("cut,keep,tail", [
    ("mid_p1", _keep_mid_p1, 4), ("mid_p2", _keep_mid_p2, 10 ** 9)])
def test_cnn_resume_is_bitwise_identical(cnn, tmp_path, cut, keep, tail):
    task, over, src, res_a = cnn
    assert "phase2-step00000004.msgpack" in os.listdir(src)
    dst = _interrupt_dir(src, str(tmp_path / cut), keep=keep)
    res_b = _run(task, dst, resume=True, **over)
    _assert_same_run(res_a, res_b, tail)
    assert res_b["final_bundle"]["state"]


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _j_and_t_states(stacked: bool):
    """One TrainState built in each package from the same numpy values."""
    rng = np.random.default_rng(0)
    lead = (3,) if stacked else ()
    bundle = {"params": {"w": rng.standard_normal(lead + (3, 4)).astype(
        np.float32), "b": rng.standard_normal(lead + (4,)).astype(np.float32)},
        "state": {"bn": {"mean": rng.standard_normal(lead + (4,)).astype(
            np.float32)}}}
    opt = {"mu": {k: rng.standard_normal(v.shape).astype(np.float32)
                  for k, v in bundle["params"].items()}}
    jb = jax.tree_util.tree_map(jnp.asarray, bundle)
    jo = jax.tree_util.tree_map(jnp.asarray, opt)
    tb, to = tio.params_from_numpy(bundle), tio.params_from_numpy(opt)
    if stacked:
        return (jloop.stack_train_state(jb, jo, 3, seed=5),
                stack_train_state(tb, to, 3, seed=5))
    return (jloop.init_train_state(jb, jo, step=17, acc_ema=0.25, seed=9),
            init_train_state(tb, to, step=17, acc_ema=0.25, seed=9))


@pytest.mark.parametrize("stacked", [False, True], ids=["phase1", "phase2"])
def test_same_state_gives_same_bytes_in_both_packages(tmp_path, stacked):
    js, ts = _j_and_t_states(stacked)
    jp, tp = str(tmp_path / "jax.msgpack"), str(tmp_path / "port.msgpack")
    jstate.save_train_state(jp, js, meta={"tag": "phase1"})
    save_train_state(tp, ts, meta={"tag": "phase1"})
    with open(jp, "rb") as f, open(tp, "rb") as g:
        assert f.read() == g.read()
    assert (jstate.read_meta(jp)["checksum"]
            == jstate.read_meta(tp)["checksum"])
    # each package restores the other's snapshot, in its own dtypes
    back = load_train_state(jp, ts)
    _assert_states_equal(back, ts)
    assert back.step.dtype == torch.int64 and back.rng.dtype == torch.int64
    jback = jstate.load_train_state(tp, js)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(js)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _close_trees(t_tree, j_tree):
    t = tree_leaves(t_tree)
    j = jax.tree_util.tree_leaves(jax.device_get(j_tree))
    assert len(t) == len(j)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_jax_snapshot_resumes_in_the_port(task, jax_uninterrupted,
                                          tmp_path):
    src, jres = jax_uninterrupted
    dst = _interrupt_dir(src, str(tmp_path / "jax_mid_p2"),
                         keep=_keep_mid_p2)
    res = _run(task, dst, resume=True)
    assert res["phase1_log"] == []
    for key in ("phase1_steps", "phase2_steps", "phase1_test_acc"):
        assert res[key] == jres[key], key
    _close_trees(res["stacked_params"], jres["stacked_params"])
    _close_trees(res["final_bundle"]["params"],
                 jres["final_bundle"]["params"])
    for key in ("before_avg_test_acc", "after_avg_test_acc"):
        np.testing.assert_allclose(res[key], jres[key], atol=1 / 512)
    np.testing.assert_allclose(res["worker_test_accs"],
                               jres["worker_test_accs"], atol=1 / 512)


def test_port_snapshot_loads_in_jax(uninterrupted, jax_uninterrupted):
    """The port's mid-phase-2 snapshot restored by JAX's
    ``load_train_state`` (into a template of the JAX run's snapshot) in
    JAX's dtypes, and repacked by JAX to the same bytes."""
    src, _ = uninterrupted
    jsrc, _ = jax_uninterrupted
    name = "phase2-step00000004.msgpack"
    path = os.path.join(src, name)
    jgot = jstate.load_train_state(path, _jax_template(jsrc, name))
    assert jgot.step.dtype == jnp.int32 and jgot.rng.dtype == jnp.uint32
    meta = jstate.read_meta(path)
    assert checkpoint_workers(meta) == 2 and meta["tag"] == "phase2"
    with open(path, "rb") as f:
        raw = f.read()
    assert jstate.checksum_bytes(raw) == meta["checksum"]
    assert jio.pack_pytree(jgot._asdict()) == raw


def _jax_template(directory, name):
    """A JAX TrainState of the snapshot's structure, read off its own
    payload (shapes and dtypes)."""
    import msgpack
    with open(os.path.join(directory, name), "rb") as f:
        payload = msgpack.unpackb(f.read(), raw=False)
    tree = {}
    for key, rec in payload.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.zeros(rec["shape"], rec["dtype"])
    scale = tree.pop("scale")
    return jloop.TrainState(**tree, scale=jloop.LossScaleState(
        *(scale["." + f] for f in jloop.LossScaleState._fields)))


# ---------------------------------------------------------------------------
# checkpoint-layer units (no training)
# ---------------------------------------------------------------------------


def test_shrink_worker_axis_units():
    assert checkpoint_workers({"n_workers": 4}) == 4
    assert checkpoint_workers({}) is None          # pre-elastic sidecar

    bundle = {"params": {"w": torch.arange(6.0).reshape(3, 2)}, "state": {}}
    opt = {"mu": {"w": torch.zeros((3, 2))}}
    state = stack_train_state(bundle, opt, 3)
    assert shrink_worker_axis(state, 3) is state   # no-op keeps buffers

    small = shrink_worker_axis(state, 2)
    _assert_leaves_equal(_state_leaves(small),
                         [t[:2] for t in _state_leaves(state)])

    with pytest.raises(ValueError, match="cloned workers"):
        shrink_worker_axis(state, 4)


def test_train_state_roundtrip_is_byte_exact(tmp_path):
    bundle = {"params": {"w": torch.arange(12.0).reshape(3, 4),
                         "b": torch.ones((4,), dtype=torch.bfloat16)},
              "state": {}}
    opt = {"mu": tree_map(torch.zeros_like, bundle["params"])}
    state = init_train_state(bundle, opt, step=17, acc_ema=0.25)
    path = str(tmp_path / "st.msgpack")
    save_train_state(path, state, meta={"tag": "phase1", "step": 17})
    out = load_train_state(path, state)
    _assert_states_equal(state, out)
    assert int(out.step) == 17


def _at(step):
    bundle = {"params": {"w": torch.zeros((2, 2))}, "state": {}}
    return init_train_state(bundle, {"mu": {"w": torch.zeros((2, 2))}},
                            step=step)


def test_checkpointer_cadence_and_resume_priority(tmp_path):
    ck = Checkpointer(str(tmp_path), every=4, keep=2)
    assert ck.maybe_save("phase1", _at(2)) is None      # off-cadence
    assert ck.maybe_save("phase1", _at(4)) is not None
    assert ck.maybe_save("phase1", _at(4)) is None      # no duplicate
    assert ck.maybe_save("phase1", _at(8)) is not None
    assert ck.maybe_save("phase1", _at(12)) is not None
    # keep=2 pruned the oldest rolling snapshot
    names = [n for n in os.listdir(tmp_path) if n.endswith(".msgpack")]
    assert sorted(names) == ["phase1-step00000008.msgpack",
                             "phase1-step00000012.msgpack"]

    ck.save("phase1_final", _at(12))
    assert find_resume_point(str(tmp_path))["tag"] == "phase1_final"
    ck.maybe_save("phase2", _at(4))
    pt = find_resume_point(str(tmp_path))
    assert (pt["tag"], pt["step"]) == ("phase2", 4)
    assert pt["meta"]["tag"] == "phase2"

    assert find_resume_point(str(tmp_path / "missing")) is None


def test_checkpointer_resume_seeds_cadence_from_disk(tmp_path):
    """A fresh Checkpointer over an existing directory takes its cadence
    from the snapshots already on disk, per tag: a resumed run does not
    snapshot at its first epoch boundary."""
    ck = Checkpointer(str(tmp_path), every=4, keep=2)
    assert ck.maybe_save("phase1", _at(8)) is not None
    assert ck.maybe_save("phase2", _at(6)) is not None

    resumed = Checkpointer(str(tmp_path), every=4, keep=2)
    # step 10 is only 2 past phase1's durable step 8: off-cadence
    assert resumed.maybe_save("phase1", _at(10)) is None
    # per-tag seeding: phase2 last saved at 6, so 10 is due
    assert resumed.maybe_save("phase2", _at(10)) is not None
    assert resumed.maybe_save("phase1", _at(12)) is not None


def test_take_worker_axis_units():
    from repro_torch.checkpoint.state import take_worker_axis
    bundle = {"params": {"w": torch.arange(8.0).reshape(4, 2)}, "state": {}}
    state = stack_train_state(bundle, {"mu": {"w": torch.zeros((4, 2))}}, 4)
    kept = take_worker_axis(state, [1, 3])
    _assert_leaves_equal(_state_leaves(kept),
                         [t[[1, 3]] for t in _state_leaves(state)])
    _assert_leaves_equal(_state_leaves(take_worker_axis(state, [0, 1])),
                         _state_leaves(shrink_worker_axis(state, 2)))
    for bad, msg in (([4], "out of range"), ([1, 1], "duplicate")):
        with pytest.raises(ValueError, match=msg):
            take_worker_axis(state, bad)


def test_publish_snapshots_and_corrupt_fallback(tmp_path):
    """Publish snapshots are invisible to resume scans; a damaged newest
    generation or resume point falls back to the one before, as JAX's."""
    from repro_torch.checkpoint import state as ts
    params = {"w": torch.arange(6.0).reshape(2, 3)}
    d = str(tmp_path)
    for gen in (1, 2):
        ts.save_publish(d, gen, 10 * gen, tree_map(lambda t: t * gen, params))
    assert [p["generation"] for p in ts.list_publishes(d)] == [1, 2]
    assert ts.list_checkpoints(d) == [] and find_resume_point(d) is None
    assert ts.find_latest_publish(d)["generation"] == 2
    path2 = ts.publish_path(d, 2, 20)
    assert jstate.read_meta(path2)["checksum"] == ts.read_meta(path2)[
        "checksum"]
    back = ts.load_publish(path2, params)
    assert torch.equal(back["w"], params["w"] * 2)
    with open(path2, "r+b") as f:
        f.seek(-1, 2)
        last = f.read(1)
        f.seek(-1, 2)
        f.write(bytes([last[0] ^ 1]))
    with pytest.warns(RuntimeWarning, match="corrupt publish"):
        assert ts.find_latest_publish(d)["generation"] == 1
    ck = Checkpointer(d, every=4, keep=0)
    ck.save("phase1", _at(4))
    p8 = ck.save("phase1", _at(8))
    with open(p8, "ab") as f:
        f.write(b"\0")
    assert not ts.verify_snapshot(p8)
    with pytest.warns(RuntimeWarning, match="corrupt checkpoint"):
        assert find_resume_point(d)["step"] == 4
    with pytest.raises(tio.ChecksumError):
        load_train_state(p8, _at(0))
