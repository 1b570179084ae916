"""SWAP training of the MoE family and MLA through the port's launcher,
against the JAX package's, on the CPU.

``repro_torch.launch.train.main`` runs deepseek-v2-lite (MoE + MLA),
granite-moe-3b-a800m (MoE + GQA) and minicpm3-4b (MLA, dense FFN) at their
smoke configs through all three phases (W 2, elastic phase 3), its adapter
initialized with JAX's params;
the reference runs the SWAP that ``repro/launch/train.py`` builds from the
same flags (the same Markov data, schedules and optimizer), from the same
params. Tolerances as ``tests/test_torch_swap.py`` holds the dense model:
the phase-1 log's loss, lr and EMA and every param (phase-1 bundle,
stacked workers, the average) at 1e-4 relative; accuracies to one argmax
hit; step counts and liveness exactly.

Both runs take the same expert choices. The trajectories drift apart by
f32 summation order (the router's probs by 5e-7 at the first call and up
to 4.6e-4 at phase 2's evals), and at this size (512 tokens a phase-1
call, top-2 of 4) a run meets tokens whose 2nd and 3rd expert probs are
closer than that: where the drift crosses such a tie, the two runs would
send the token to different experts and their losses would part by
~1e-4 (at the launcher's seed, 4 tokens of deepseek-v2-lite's run and 3
of granite-moe's). So the reference's run records each top-k it
takes (``jax.debug.callback``: its probs and experts, per worker under
vmap), and each router call of the port's run replays the experts of the
recorded call whose probs are nearest its own (within ``MATCH_TOL``),
with the gates recomputed from its own probs. The router itself is held
apart from that: on every call the reference's router (its softmax and
``jax.lax.top_k``) given the port's inputs picks the port's own experts.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs as parallel test processes

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.core.adapters import LMAdapter as JAdapter  # noqa: E402
from repro.core.swap import SWAP as JSWAP  # noqa: E402
from repro.data.pipeline import Loader as JLoader  # noqa: E402
from repro.data.pipeline import make_markov_lm  # noqa: E402
from repro.dist.config import DistConfig as JDist  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.core.adapters import LMAdapter  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = 1e-4
# a port router call and the reference's call it replays: max |probs
# difference| (up to 4.6e-4 at this size; any other call of the run is
# 0.65 or more away)
MATCH_TOL = 1e-2
ARGV = ["--device", "cpu", "--workers", "2",
        "--phase1-steps", "4", "--phase2-steps", "3", "--phase1-batch", "32",
        "--phase2-batch", "8", "--seq-len", "16", "--elastic-deadline", "30"]


def _jax_launcher_swap(args):
    """The SWAP run ``repro/launch/train.py`` builds from ``args`` (its
    data, loaders, optimizer and phase schedules)."""
    cfg = jreg.get_smoke_config(args.arch)
    data = make_markov_lm(args.seed, vocab=min(cfg.vocab_size, 512),
                          n_train=4096, n_test=1024, seq_len=args.seq_len)
    train = {"tokens": data["train_tokens"] % cfg.vocab_size,
             "labels": data["train_labels"] % cfg.vocab_size}
    test = JLoader({"tokens": data["test_tokens"] % cfg.vocab_size,
                    "labels": data["test_labels"] % cfg.vocab_size}, 256)
    lr_small = args.peak_lr * args.phase2_batch / args.phase1_batch
    adapter = JAdapter(cfg, jbase.OptimizerConfig(kind=args.optimizer,
                                                  weight_decay=5e-4))
    sched = jbase.ScheduleConfig
    swap_cfg = jbase.SWAPConfig(
        n_workers=args.workers,
        phase1=jbase.PhaseConfig(
            batch_size=args.phase1_batch, max_steps=args.phase1_steps,
            stop_accuracy=args.stop_acc,
            schedule=sched(kind="warmup_linear", peak_lr=args.peak_lr,
                           warmup_steps=args.phase1_steps // 5,
                           total_steps=args.phase1_steps)),
        phase2=jbase.PhaseConfig(
            batch_size=args.phase2_batch, max_steps=args.phase2_steps,
            schedule=sched(kind="warmup_linear", peak_lr=lr_small,
                           warmup_steps=0, total_steps=args.phase2_steps)),
        seed=args.seed)
    dist = JDist(n_workers=args.workers,
                 elastic_deadline_s=args.elastic_deadline)
    return adapter, JSWAP(adapter, swap_cfg, train, test, dist=dist)


class FromJax(LMAdapter):
    """The port's LM adapter, initialized with JAX's params."""

    jax_params = None

    def init(self, gen):
        return {"params": params_from_numpy(self.jax_params,
                                            device=gen.device), "state": {}}


def _recording_top_k(records):
    """``jax.lax.top_k`` that also appends each call's (input, indices) to
    ``records`` as numpy arrays when the program runs."""
    real = jax.lax.top_k

    def top_k(operand, k):
        vals, idx = real(operand, k)
        jax.debug.callback(
            lambda p, i: records.append((np.asarray(p), np.asarray(i))),
            operand, idx)
        return vals, idx
    return top_k


def _replayed_route(records, calls):
    """``moe.route`` that takes the experts of the reference's recorded
    call nearest in probs, its gates from its own probs, and appends
    (tokens, tokens the reference's router sends elsewhere than the port's
    on these inputs, the distances to the nearest and the next recorded
    call, tokens the replay moved)."""
    real = tmoe.route

    def route(params, x, cfg):
        probs, _, idx = real(params, x, cfg)
        logits = jnp.matmul(jnp.asarray(x.detach().float().numpy()),
                            jnp.asarray(params["router"].detach().numpy()))
        _, want = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                cfg.moe.top_k)
        p = probs.detach().numpy()
        near = sorted(((float(np.abs(rp - p).max()), i)
                       for i, (rp, _) in enumerate(records)
                       if rp.shape == p.shape)) + [(np.inf, None)] * 2
        (dist, i), (second, _) = near[:2]
        new = idx if i is None else torch.from_numpy(
            records[i][1].astype(np.int64))
        calls.append((idx.shape[0] * idx.shape[1],
                      int((np.asarray(want) != idx.numpy()).any(-1).sum()),
                      dist, second, int((new != idx).any(-1).sum())))
        gates = probs.gather(-1, new)
        return probs, gates / gates.sum(dim=-1, keepdim=True), new
    return route


def _launcher_runs(arch):
    """(the reference's results, the port's, the port's router calls) of
    the two launchers' SWAP runs of ``arch`` from the same params."""
    argv = ["--arch", arch] + ARGV
    args = tlaunch.build_parser().parse_args(argv)
    jad, jswap = _jax_launcher_swap(args)
    key = jax.random.PRNGKey(args.seed)
    records, calls = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", _recording_top_k(records))
        jres = jswap.run(key)
        jax.effects_barrier()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(FromJax, "jax_params",
                   jax.device_get(jad.init(key)["params"]))
        mp.setattr(tlaunch, "LMAdapter", FromJax)
        mp.setattr(tmoe, "route", _replayed_route(records, calls))
        tres = tlaunch.main(argv)
    return jres, tres, calls


@pytest.fixture(scope="module",
                params=["deepseek-v2-lite", "granite-moe-3b-a800m"])
def runs(request):
    return _launcher_runs(request.param)


@pytest.fixture(scope="module")
def dense_runs():
    """minicpm3-4b: MLA with a dense FFN, so no router call to replay."""
    return _launcher_runs("minicpm3-4b")


def test_moe_swap_router_picks_the_reference_experts(runs):
    """Every router call of the run (4 phase-1 steps, 2 x 3 phase-2 steps,
    the evals; 2 MoE layers each) routes as the reference's router does on
    the same inputs, and replays a call of the reference's run."""
    _, _, calls = runs
    assert len(calls) >= 2 * (4 + 2 * 3)
    assert sum(n for n, *_ in calls) > 0
    assert [bad for _, bad, *_ in calls] == [0] * len(calls)
    for _, _, dist, second, _ in calls:
        assert dist <= MATCH_TOL < second


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _close_trees(t_tree, j_tree):
    t, j = _flat(t_tree), _flat(jax.device_get(j_tree))
    assert t.keys() == j.keys()
    for k in j:
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_moe_swap_counts_and_masks_match_jax(runs):
    _check_counts(*runs)


def test_mla_dense_swap_matches_jax(dense_runs):
    """minicpm3-4b's smoke run through both launchers: no router call, and
    the counts, the phase-1 log, the accuracies and every param as the MoE
    runs are held."""
    jres, tres, calls = dense_runs
    assert calls == []
    _check_counts(*dense_runs)
    _check_phase1_log(*dense_runs)
    _check_accuracies_and_params(*dense_runs)


def _check_counts(jres, tres, _):
    for key in ("phase1_steps", "phase2_steps", "phase1_skipped_steps",
                "phase2_live_workers", "worker_live_mask",
                "phase2_worker_ids"):
        assert tres[key] == jres[key], key
    assert tres["phase1_steps"] == 4 and tres["phase2_steps"] == 3


def test_moe_swap_phase1_log_matches_jax(runs):
    _check_phase1_log(*runs)


def _check_phase1_log(jres, tres, _):
    jl, tl = jres["phase1_log"], tres["phase1_log"]
    assert [e["step"] for e in tl] == [e["step"] for e in jl]
    for key in ("loss", "lr", "ema"):
        np.testing.assert_allclose([e[key] for e in tl],
                                   [e[key] for e in jl], rtol=TOL,
                                   err_msg=key)
    # batch of 32 x 16 tokens: one argmax hit is 1/512
    np.testing.assert_allclose([e["accuracy"] for e in tl],
                               [e["accuracy"] for e in jl], atol=1 / 512)


def test_moe_swap_accuracies_and_averaged_params_match_jax(runs):
    _check_accuracies_and_params(*runs)


def _check_accuracies_and_params(jres, tres, _):
    hit = 1 / (256 * 16)           # one argmax hit in a test batch
    for key in ("phase1_test_acc", "before_avg_test_acc",
                "after_avg_test_acc", "phase1_train_acc"):
        np.testing.assert_allclose(tres[key], jres[key], atol=hit,
                                   err_msg=key)
    np.testing.assert_allclose(tres["worker_test_accs"],
                               jres["worker_test_accs"], atol=hit)
    _close_trees(tres["phase1_bundle"]["params"],
                 jres["phase1_bundle"]["params"])
    _close_trees(tres["stacked_params"], jres["stacked_params"])
    _close_trees(tres["final_bundle"]["params"],
                 jres["final_bundle"]["params"])
