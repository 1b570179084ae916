"""SWAP across processes (``repro_torch.core.swap`` on ``torch.distributed``
with gloo over loopback TCP), held against the single-process port.

Each case spawns its processes as this file run as a script (``python
test_torch_multiprocess.py child ...``), one CPU thread each, on a tiny LM.
The oracle runs in the test process, also on one thread, from the phase-1
model the processes trained:

  * ``worker:2`` over two processes, on either phase-2 engine: each
    worker's phase-2 params, the elastic and the strict averages and the
    worker accuracies are bitwise the single-process port's; phase 1
    (data parallel: the mean of two half-batch gradients) is within
    PHASE1_RTOL of the single-process phase 1, and a planted fault that
    keeps the ranks equal (both read shard 0) is not; on the ``sharded``
    engine no phase-2 collective and one phase-3 broadcast a leaf a
    worker, on ``vmap`` (every rank trains every worker) no collective
    after phase 1; resumed on both ranks from a single-process run's
    ``phase1_final`` snapshot, the workers and the average are bitwise
    that run's;
  * ``worker:2,data:2`` over four: the recorded phase-2 collectives stay
    inside their worker blocks, a cross-block all_reduce planted in phase 2
    is caught by the audit, and each worker is within WORKER_RTOL of the
    single-process worker from the same phase-1 model;
  * the launcher over two processes, one failing after the rendezvous:
    both exit non-zero.

Every rendezvous and collective has a timeout (CHILD_TIMEOUT_S), and every
wait on a child PROC_TIMEOUT_S, so a hang fails the test in under two
minutes.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # bitwise across processes needs one thread

from repro_torch.configs import base  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.core.averaging import average_stacked  # noqa: E402
from repro_torch.core.swap import SWAP  # noqa: E402
from repro_torch.data.pipeline import Loader, make_markov_lm  # noqa: E402
from repro_torch.dist.config import DistConfig  # noqa: E402
from repro_torch.dist.sharding import (  # noqa: E402
    CollectiveRecord, assert_no_cross_worker_collectives, collective_bytes)
from repro_torch.optim.api import tree_leaves, tree_map  # noqa: E402
from repro_torch.train.loop import run_phase  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHILD_TIMEOUT_S = 60.0
PROC_TIMEOUT_S = 110.0
# phase 1 over two or four ranks sums their half-batch gradients: f32
# rounding in another order, over 4 SGD steps
PHASE1_RTOL = 1e-5
# phase 2 with data 2: the same, over 4 worker steps
WORKER_RTOL = 1e-5
TINY = dict(name="tiny-lm", family="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=32,
            attention="gqa", dtype="float32", remat=False,
            scan_layers=False)
W = 2


def _swap(dist: DistConfig) -> SWAP:
    cfg = base.SWAPConfig(
        n_workers=W, seed=3, bn_recompute_batch_size=32,
        phase1=base.PhaseConfig(
            batch_size=16, max_steps=4,
            schedule=base.ScheduleConfig(kind="warmup_linear", peak_lr=0.2,
                                         warmup_steps=2, total_steps=4)),
        phase2=base.PhaseConfig(
            batch_size=8, max_steps=4,
            schedule=base.ScheduleConfig(kind="warmup_linear", peak_lr=0.05,
                                         total_steps=4)))
    data = make_markov_lm(0, vocab=32, n_train=128, n_test=32, seq_len=16)
    train = {"tokens": data["train_tokens"], "labels": data["train_labels"]}
    test = Loader({"tokens": data["test_tokens"],
                   "labels": data["test_labels"]}, 16)
    adapter = LMAdapter(base.ModelConfig(**TINY), base.OptimizerConfig())
    return SWAP(adapter, cfg, train, test, dist=dist)


def _dist(mesh, n_proc=1, rank=0, port=0, **kw) -> DistConfig:
    from repro_torch.dist.config import parse_mesh
    shape, axes = parse_mesh(mesh)
    return DistConfig(mesh_shape=shape, mesh_axes=axes, n_workers=W,
                      coordinator=f"127.0.0.1:{port}" if n_proc > 1 else "",
                      num_processes=n_proc, process_id=rank, backend="gloo",
                      **kw)


# ---------------------------------------------------------------------------
# the processes
# ---------------------------------------------------------------------------


def _child(mesh: str, n_proc: int, rank: int, port: int, out: str,
           engine: str) -> None:
    """One rank: SWAP with the elastic phase 3 on ``engine``, then the
    strict average of the same workers; on ``worker:2``'s sharded engine
    also a run whose ranks all read shard 0 of phase 1's batches (a
    planted data-parallel fault); with data 2 also a run whose phase-2
    step group is the whole world (a planted cross-block collective)."""
    import dataclasses

    dist = _dist(mesh, n_proc, rank, port, elastic_deadline_s=30.0,
                 phase2_engine=engine)
    dist.initialize(device="cpu", timeout_s=CHILD_TIMEOUT_S)
    try:
        swap = _swap(dist)
        res = swap.run(torch.Generator().manual_seed(0))
        strict = _swap(dataclasses.replace(dist, elastic_deadline_s=0.0))
        place = strict.placement()
        avg_strict, _ = (
            strict.gather_average(res["stacked_params"], place)
            if place.engine == "sharded"
            else strict.average(res["stacked_params"]))
        record = {
            "phase1": res["phase1_bundle"]["params"],
            "workers": res["local_worker_ids"],
            "local": res["stacked_params"],
            "elastic": res["final_bundle"]["params"],
            "strict": avg_strict,
            "accs": res["worker_test_accs"],
            "mask": res["worker_live_mask"],
            "records": [tuple(r) for r in res["collectives"]]}
        ck = os.path.join(out, "ck")
        if os.path.isdir(ck):        # a snapshot loaded on every rank
            resumed = _swap(dist)
            resumed.cfg = dataclasses.replace(resumed.cfg, checkpoint_dir=ck)
            again = resumed.run(torch.Generator().manual_seed(0), resume=True)
            record["resumed"] = (again["stacked_params"],
                                 again["final_bundle"]["params"])
        if mesh == "worker:2" and place.engine == "sharded":
            honest = DistConfig.data_shard
            DistConfig.data_shard = property(
                lambda d: (0, d.num_processes))
            try:
                bad = _swap(dist).run(torch.Generator().manual_seed(0))
            finally:
                DistConfig.data_shard = honest
            record["shard0"] = bad["phase1_bundle"]["params"]
        if "data" in mesh:
            planted = _swap(dist)
            honest = planted.placement

            def plant(recorder=None):
                place = honest(recorder)
                return place._replace(block_group=place.world_group)

            planted.placement = plant
            bad = planted.run(torch.Generator().manual_seed(0))
            record["planted"] = [tuple(r) for r in bad["collectives"]]
        torch.save(record, os.path.join(out, f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    src = str(ROOT / "src")
    pp = os.environ.get("PYTHONPATH", "")
    return dict(os.environ, PYTHONPATH=src + (os.pathsep + pp if pp else ""),
                OMP_NUM_THREADS="1")


def _wait(procs):
    """Every child's (returncode, output); a child past PROC_TIMEOUT_S is
    killed, with the others, and fails the test."""
    outs = []
    try:
        for p in procs:
            outs.append((p.communicate(timeout=PROC_TIMEOUT_S)[0],
                         p.returncode))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _spawn(mesh: str, n_proc: int, out: Path, engine: str = "auto"):
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "child", mesh, str(n_proc), str(rank),
         str(port), str(out), engine], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(n_proc)]
    for rank, (text, rc) in enumerate(_wait(procs)):
        assert rc == 0, f"rank {rank} of {mesh} failed:\n{text}"
    return [torch.load(out / f"rank{r}.pt") for r in range(n_proc)]


# ---------------------------------------------------------------------------
# the oracle
# ---------------------------------------------------------------------------


def _oracle(phase1_params, elastic=True):
    """The single-process port's phase 2 and 3 from ``phase1_params``:
    (stacked workers, averaged params, worker accuracies)."""
    swap = _swap(DistConfig(n_workers=W,
                            elastic_deadline_s=30.0 if elastic else 0.0))
    bundle = {"params": tree_map(lambda a: a.clone(), phase1_params),
              "state": {}}
    runner, state = swap.phase2(bundle)
    state = run_phase(runner, state, list(range(W)),
                      max_steps=swap.cfg.phase2.max_steps).state
    stacked = state.bundle["params"]
    avg, mask = swap.average(stacked)
    accs = [swap.adapter.eval_accuracy(
        {"params": tree_map(lambda a: a[w], stacked), "state": {}},
        swap.test_loader) for w in range(W)]
    return stacked, avg, accs


def _rel(a_tree, b_tree) -> float:
    num = sum(float(((a - b) ** 2).sum()) for a, b in
              zip(tree_leaves(a_tree), tree_leaves(b_tree)))
    den = sum(float((b ** 2).sum()) for b in tree_leaves(b_tree))
    return (num / den) ** 0.5


def _equal(a_tree, b_tree) -> bool:
    return all(torch.equal(a, b) for a, b in
               zip(tree_leaves(a_tree), tree_leaves(b_tree)))


def _single_phase1():
    res = _swap(DistConfig(n_workers=W)).run(torch.Generator().manual_seed(0))
    return res["phase1_bundle"]["params"]


@pytest.mark.parametrize("engine", ["sharded", "vmap"])
def test_two_processes_match_the_single_process_port(tmp_path, engine):
    """worker:2 over two gloo processes: workers, both averages and the
    accuracies bitwise; phase 1 within PHASE1_RTOL, and both ranks on
    shard 0 outside it; the recorder's collectives where the layout puts
    them. On the sharded engine also a run resumed on both ranks from a
    single-process run's phase1_final snapshot: its workers and average
    bitwise that run's."""
    import dataclasses
    sharded = engine == "sharded"
    if sharded:
        single = _swap(DistConfig(n_workers=W, elastic_deadline_s=30.0))
        single.cfg = dataclasses.replace(single.cfg,
                                         checkpoint_dir=str(tmp_path / "ck"))
        want = single.run(torch.Generator().manual_seed(0))
    ranks = _spawn("worker:2", 2, tmp_path, engine)
    assert _equal(ranks[0]["phase1"], ranks[1]["phase1"])
    one = _single_phase1()
    rel = _rel(ranks[0]["phase1"], one)
    assert rel <= PHASE1_RTOL, rel
    if sharded:
        assert _equal(ranks[0]["shard0"], ranks[1]["shard0"])
        planted = _rel(ranks[0]["shard0"], one)
        assert planted > 10 * PHASE1_RTOL, planted
    stacked, elastic, accs = _oracle(ranks[0]["phase1"])
    _, strict, _ = _oracle(ranks[0]["phase1"], elastic=False)
    assert _equal(strict, average_stacked(stacked))
    n_leaves = len(tree_leaves(stacked))
    for r, got in enumerate(ranks):
        rows = [r] if sharded else list(range(W))
        assert got["workers"] == rows
        assert _equal(got["local"],
                      tree_map(lambda a: a[rows[0]:rows[-1] + 1], stacked))
        assert _equal(got["elastic"], elastic)
        assert _equal(got["strict"], strict)
        assert got["accs"] == accs and got["mask"] == [True, True]
        recs = [CollectiveRecord(*t) for t in got["records"]]
        assert all(r.op == "all_reduce" and r.ranks == (0, 1)
                   for r in recs if r.phase == "phase1")
        if not sharded:
            assert {r.phase for r in recs} == {"phase1"}
            continue
        local, avg = got["resumed"]
        assert _equal(local, tree_map(lambda a: a[r:r + 1],
                                      want["stacked_params"]))
        assert _equal(avg, want["final_bundle"]["params"])
        phases = {r.phase for r in recs}
        assert phases == {"phase1", "eval", "phase3"}, phases
        p3 = [r for r in recs if r.phase == "phase3"]
        assert len(p3) == n_leaves * W and {r.op for r in p3} == \
            {"broadcast"}
        assert collective_bytes(recs, "phase3")["broadcast"] == sum(
            a.numel() * 4 for a in tree_leaves(stacked))


def test_four_processes_keep_phase2_in_its_blocks(tmp_path):
    """worker:2,data:2 over four gloo processes: phase 2's collectives stay
    in their blocks, a planted one is caught, and each worker is within
    WORKER_RTOL of the single-process worker."""
    ranks = _spawn("worker:2,data:2", 4, tmp_path)
    assert _rel(ranks[0]["phase1"], _single_phase1()) <= PHASE1_RTOL
    stacked, _, _ = _oracle(ranks[0]["phase1"])
    for r, got in enumerate(ranks):
        assert _equal(got["phase1"], ranks[0]["phase1"])
        w = r // 2
        assert got["workers"] == [w]
        assert _equal(got["local"], ranks[2 * w]["local"])
        rel = _rel(got["local"], tree_map(lambda a: a[w:w + 1], stacked))
        assert rel <= WORKER_RTOL, (r, rel)
        assert _equal(got["elastic"], ranks[0]["elastic"])
        recs = [CollectiveRecord(*t) for t in got["records"]]
        phase2 = [x for x in recs if x.phase == "phase2"]
        assert phase2 and all(x.ranks == (2 * w, 2 * w + 1) for x in phase2)
        assert assert_no_cross_worker_collectives(phase2, W, 4) == \
            len(phase2)
        planted = [CollectiveRecord(*t) for t in got["planted"]
                   if t[3] == "phase2"]
        with pytest.raises(AssertionError, match="spans workers"):
            assert_no_cross_worker_collectives(planted, W, 4)


def test_a_failed_rank_fails_the_launch(tmp_path):
    """Two launcher processes; rank 1 is refused after the rendezvous (the
    CNN), so rank 0's first collective finds it gone: both exit
    non-zero, well within the timeouts."""
    port = _free_port()
    common = ["--device", "cpu", "--workers", "2", "--mesh", "worker:2",
              "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
              "--phase1-batch", "16", "--phase2-batch", "8", "--seq-len",
              "16", "--phase1-steps", "2", "--phase2-steps", "1"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *common,
         "--process-id", str(rank)] + (["--arch", "cifar-cnn"] if rank
                                       else []),
        env=_env(), cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    (out0, rc0), (out1, rc1) = _wait(procs)
    assert rc1 != 0 and "CNN" in out1, out1
    assert rc0 != 0 and "backend=gloo" in out0, out0


def test_train_lm_swap_twin_prints_the_example_summary(capsys, tmp_path):
    """``experiments.train_lm_swap`` (the twin of
    ``examples/train_lm_swap.py``) with its flags, in one process: the
    example's summary lines, and the DistConfig it dumps."""
    from repro_torch.experiments import train_lm_swap
    dump = tmp_path / "dist.json"
    res = train_lm_swap.main(
        ["--arch", "internlm2-1.8b", "--steps1", "2", "--steps2", "1",
         "--seq-len", "16", "--workers", "2", "--elastic-deadline", "30",
         "--mesh", "worker:1", "--device", "cpu",
         "--dump-dist-config", str(dump)])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0].split(" ")[0] for line in out] == \
        ["model", "phase1", "workers", "SWAP", "times"]
    assert res["phase1_steps"] == 2 and res["phase2_steps"] == 1
    assert np.isfinite(res["after_avg_test_acc"])
    assert DistConfig.from_json(str(dump)) == DistConfig(
        mesh_shape=(1,), mesh_axes=("worker",), n_workers=2,
        elastic_deadline_s=30.0)


# ---------------------------------------------------------------------------
# the audit and the refusals, in this process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranks,ok", [((0, 1), True), ((2, 3), True),
                                      ((1, 2), False), ((0, 1, 2, 3), False)])
def test_audit_on_records(ranks, ok):
    recs = [CollectiveRecord("all_reduce", ranks, 64, "phase2", 0.0)]
    if ok:
        assert assert_no_cross_worker_collectives(recs, 2, 4) == 1
    else:
        with pytest.raises(AssertionError, match="spans workers"):
            assert_no_cross_worker_collectives(recs, 2, 4)


def test_collective_bytes_by_op_and_phase():
    recs = [CollectiveRecord("all_reduce", (0, 1), 64, "phase1", 0.0),
            CollectiveRecord("broadcast", (0, 1), 32, "phase3", 0.0),
            CollectiveRecord("broadcast", (0, 1), 32, "phase3", 0.0)]
    assert collective_bytes(recs) == {"all_reduce": 64, "broadcast": 64}
    assert collective_bytes(recs, "phase3") == {"broadcast": 64}


def test_refusals_cite_a13c(tmp_path):
    """A model axis, a supervisor, heartbeats and snapshot writes across
    processes are refused (ROADMAP A13c) before any process group."""
    from repro_torch.resilience import PhaseSupervisor
    with pytest.raises(NotImplementedError, match="A13c"):
        _swap(_dist("worker:1,model:2"))
    many = _dist("worker:2", n_proc=2, port=1)
    swap = _swap(many)
    with pytest.raises(NotImplementedError, match="supervisor.*A13c"):
        SWAP(swap.adapter, swap.cfg, swap.train_arrays, swap.test_loader,
             dist=many, supervisor=PhaseSupervisor())
    with pytest.raises(NotImplementedError, match="heartbeats.*A13c"):
        swap.run(torch.Generator(), heartbeats=object())
    import dataclasses
    swap.cfg = dataclasses.replace(swap.cfg, checkpoint_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="snapshots.*A13c"):
        swap.run(torch.Generator())
    with pytest.raises(RuntimeError, match="initialize"):
        swap.run(torch.Generator(), resume=True)


if __name__ == "__main__" and sys.argv[1:2] == ["child"]:
    _child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
           int(sys.argv[5]), sys.argv[6], sys.argv[7])
