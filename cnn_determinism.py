#!/usr/bin/env python3
"""Whether the CNN's training on the card gives the same bits in two
processes, which card op decides it, and what the repair costs.

    python3 cnn_determinism.py [--steps 24]

At the full width of cifar-cnn ``config()``, under two arms: ``model``
(``models.cnn`` as it stands: its convolutions on cuDNN's deterministic
algorithms) and ``default`` (cuDNN's default algorithm choice: the
model's ``_deterministic`` replaced by a null context):

1. each of the eight convolutions' forward and backward (dx, dw), on the
   input and cotangent the model gave it at batch 512, launched twice in
   one process: bitwise equal to itself or not;
2. the whole-model forward (logits, new BN state) and grads twice in one
   process, the model's other ops (BN, ReLU, the max pools) included;
3. ``--steps`` steps of Table 1's large-batch run
   (``experiments.common.run_sgd``, batch 512, lr 1.2, seed 0) in two
   fresh processes: the sha256 of the trained params and BN state, and
   whether the per-step losses agree;
4. ms per step of that run (512 images; host clock to a synchronize, mean
   of 10 after 2 warm-up steps) under each arm, in turns (A, B, B, A) in
   one process.

Needs a card.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.models import cnn  # noqa: E402

ARMS = ("model", "default")
LARGE = dict(batch_size=512, peak_lr=1.2)
NOISE = 3.5


@contextlib.contextmanager
def arm(name: str):
    """The model's convolutions under ``name``."""
    old = cnn._deterministic
    if name == "default":
        cnn._deterministic = contextlib.nullcontext
    try:
        yield
    finally:
        cnn._deterministic = old


def _bits(tensors) -> bytes:
    return b"".join(t.detach().contiguous().cpu().view(torch.uint8)
                    .numpy().tobytes() for t in tensors)


def _same(a, b) -> bool:
    return _bits(a) == _bits(b)


def _task(cfg):
    from repro_torch.experiments.common import cnn_task
    return cnn_task(seed=0, noise=NOISE, cfg=cfg, device="cuda")


def child(name: str, steps: int) -> None:
    """One fresh process: ``steps`` steps of the large-batch run; prints
    the sha256 of the params and BN state and the per-step losses."""
    from repro_torch.configs import registry
    from repro_torch.experiments.common import run_sgd
    from repro_torch.optim.api import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    log = []
    with arm(name):
        from repro_torch.core import swap
        orig = swap.run_phase

        def logged(*a, **kw):
            return orig(*a, **dict(kw, log=log))

        swap.run_phase = logged
        res = run_sgd(*_task(registry.get_config("cifar-cnn")), seed=0,
                      steps=steps, device="cuda", **LARGE)
    b = res["bundle"]
    sha = hashlib.sha256(_bits(tree_leaves(b["params"])
                               + tree_leaves(b["state"]))).hexdigest()
    print(json.dumps({"sha": sha, "loss": [e["loss"] for e in log]}))


def _convs(cfg, batch):
    """The eight convolutions' (x, w, gy) from one train-mode forward and
    backward of the full-width model at ``batch``."""
    from cnn_conv_accuracy import cnn_grads
    g = torch.Generator(device="cuda").manual_seed(21)
    params, state = cnn.init_cnn(g, cfg)
    x = torch.randn(batch, cfg.image_size, cfg.image_size, 3, generator=g,
                    device="cuda")
    cot = torch.randn(batch, cfg.n_classes, generator=g, device="cuda")
    convs = []
    cnn_grads(params, state, x, cot, cfg, "cuda", convs=convs)
    return convs, (params, state, x, cot, cfg)


def in_process(cfg, batch: int) -> None:
    from cnn_conv_accuracy import cnn_grads
    convs, model = _convs(cfg, batch)
    for name in ARMS:
        fwd_diff, dx_diff, dw_diff = [], [], []
        with arm(name):
            for i, (x, w, gy) in enumerate(convs):
                outs = []
                for _ in range(2):
                    xs = x.clone().requires_grad_()
                    ws = w.clone().requires_grad_()
                    y = cnn._conv(xs, ws)
                    dx, dw = torch.autograd.grad(y, (xs, ws), gy)
                    outs.append((y.detach(), dx, dw))
                (y0, dx0, dw0), (y1, dx1, dw1) = outs
                for lst, a, b in ((fwd_diff, y0, y1), (dx_diff, dx0, dx1),
                                  (dw_diff, dw0, dw1)):
                    if not _same([a], [b]):
                        d = (a - b).abs().max().item()
                        lst.append(f"conv {i} {tuple(x.shape)} "
                                   f"{w.shape[2]}->{w.shape[3]} ({d:.2e})")
            runs = [cnn_grads(*model, "cuda") for _ in range(2)]
        print(f"[in-process {name}] each convolution launched twice at "
              f"batch {batch}, not bitwise equal to itself: forward "
              f"{fwd_diff or 'none'}; dx {dx_diff or 'none'}; dw "
              f"{dw_diff or 'none'}", flush=True)
        print(f"[in-process {name}] whole model twice: forward and new BN "
              f"state bitwise {_same(runs[0][0], runs[1][0])}, grads "
              f"bitwise {_same(runs[0][1], runs[1][1])}", flush=True)


def across_processes(steps: int) -> None:
    for name in ARMS:
        outs = []
        for _ in range(2):
            proc = subprocess.run(
                [sys.executable, __file__, "--child", name, "--steps",
                 str(steps)], capture_output=True, text=True, cwd=ROOT,
                timeout=600)
            if proc.returncode:
                sys.exit(f"child {name} failed:\n{proc.stderr[-3000:]}")
            outs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        a, b = outs
        first = next((i for i, (x, y) in enumerate(zip(a["loss"], b["loss"]))
                      if x != y), None)
        print(f"[processes {name}] {steps} steps of the large-batch run in "
              f"two processes: params and BN state bitwise "
              f"{a['sha'] == b['sha']} ({a['sha'][:12]} / {b['sha'][:12]}); "
              f"losses equal {a['loss'] == b['loss']}, first differing step "
              f"{first}; final loss {a['loss'][-1]!r} / {b['loss'][-1]!r}",
              flush=True)


def step_ms(cfg) -> None:
    from repro_torch.configs.base import PhaseConfig, ScheduleConfig
    from repro_torch.core.swap import SGDRun
    adapter, train, _ = _task(cfg)
    phase = PhaseConfig(batch_size=512, max_steps=120,
                        schedule=ScheduleConfig(kind="warmup_linear",
                                                peak_lr=1.2, warmup_steps=24,
                                                total_steps=120))
    run = SGDRun(adapter, phase, train, seed=0, device="cuda")
    bundle = adapter.init(torch.Generator(device="cuda").manual_seed(0))
    box = [run.init_state(bundle)]
    times = {n: [] for n in ARMS}
    for name in ("model", "default", "default", "model"):
        with arm(name):
            for _ in range(2):
                box[0], _ = run.runner.run_chunk(box[0], 0, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                box[0], _ = run.runner.run_chunk(box[0], 0, 1)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / 10)
    print("[step] ms per large-batch step (512 images), in turns model, "
          "default, default, model: "
          + "; ".join(f"{n} {sum(v) / len(v):.3f} ({', '.join(f'{t:.3f}' for t in v)})"
                      for n, v in times.items()), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--child", choices=ARMS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("cnn_determinism.py needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.child:
        child(args.child, args.steps)
        return
    from repro_torch.configs import registry
    cfg = registry.get_config("cifar-cnn")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    in_process(cfg, args.batch)
    across_processes(args.steps)
    step_ms(cfg)


if __name__ == "__main__":
    main()
