#!/usr/bin/env python3
"""Whether the CNN's training on the card gives the same bits in two
processes, which card op decides it, and what the repair costs.

    python3 cnn_determinism.py [--steps 24]

At the full width of cifar-cnn ``config()``, under three arms: ``model``
(``models.cnn`` as it stands: its convolutions as im2col products in full
f32), ``cudnn`` (the port's earlier convolutions: cuDNN in full f32
by its deterministic algorithms, ``CudnnConv``) and ``default`` (the
same with cuDNN's default algorithm choice):

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
   of 10 after 2 warm-up steps) under each arm, in turns (A, B, C, C, B,
   A) in one process.

    python3 cnn_determinism.py --pressure [--arm model] [--margins ...]

5. whether the bits of one train step depend on what the process did
   before: one full-width forward and grads step (``STEP_BATCH`` images,
   params, batch and augmentation seed from seed 0, ``CNNAdapter``'s
   loss) in a fresh process, then in one process per margin that first
   fills the card (``fill_card``: 1 GiB segments carved into 64 MiB
   blocks, every other block of the first ones freed again, so the
   allocator holds holes it cannot return) until only that fraction of
   the fresh step's peak is free, and in one more filled to
   ``pressure_margin_mb`` (the margin ``chip_smoke.py``'s check takes:
   room for the step's tensors and 2 GiB of scratch, not for a larger
   workspace). For each: the sha256 of the loss, the
   grads and the new BN state, and, per convolution in launch order
   (forward, then the backward in reverse), the sha256 of what it
   returned, the memory it held beyond its outputs while it ran (the
   workspace or scratch) and the CUDA kernels it launched
   (torch.profiler); the first convolution whose bits part, and whose
   kernels changed.

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
import torch.nn.functional as F  # noqa: E402

from repro_torch.models import cnn  # noqa: E402

ARMS = ("model", "cudnn", "default")
LARGE = dict(batch_size=512, peak_lr=1.2)
NOISE = 3.5
STEP_BATCH = 512
# the scratch a convolution may take under chip_smoke.py's memory pressure
SCRATCH_MB = 2048


class CudnnConv(torch.autograd.Function):
    """The port's earlier convolution: cuDNN in full f32, forward and
    backward, by its deterministic algorithms (``deterministic``) or by
    its default choice."""
    deterministic = True

    @staticmethod
    def _flags():
        from cnn_conv_accuracy import _no_tf32
        stack = contextlib.ExitStack()
        stack.enter_context(torch.backends.cudnn.flags(
            enabled=True, benchmark=False,
            deterministic=CudnnConv.deterministic, allow_tf32=False))
        stack.enter_context(_no_tf32())
        return stack

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with CudnnConv._flags():
            y = F.conv2d(cnn._nchw(x), w.permute(3, 2, 0, 1), padding=1)
        return cnn._nhwc(y)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with CudnnConv._flags():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                cnn._nchw(gy), cnn._nchw(x), w.permute(3, 2, 0, 1), None,
                [1, 1], [1, 1], [1, 1], False, [0, 0], 1, mask)
        return (cnn._nhwc(gx) if gx is not None else None,
                gw.permute(2, 3, 1, 0) if gw is not None else None)


def conv_class(name: str):
    """The autograd Function of an arm's convolutions."""
    return cnn._Conv if name == "model" else CudnnConv


@contextlib.contextmanager
def arm(name: str):
    """The model's convolutions under ``name``."""
    old = cnn._conv
    if name != "model":
        CudnnConv.deterministic = name == "cudnn"
        cnn._conv = CudnnConv.apply
    try:
        yield
    finally:
        cnn._conv = old


def _bits(tensors) -> bytes:
    return b"".join(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8)
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
    for name in ARMS + ARMS[::-1]:
        with arm(name):
            for _ in range(2):
                box[0], _ = run.runner.run_chunk(box[0], 0, 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                box[0], _ = run.runner.run_chunk(box[0], 0, 1)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / 10)
    print("[step] ms per large-batch step (512 images), in turns "
          f"{', '.join(ARMS + ARMS[::-1])}: "
          + "; ".join(f"{n} {sum(v) / len(v):.3f} ({', '.join(f'{t:.3f}' for t in v)})"
                      for n, v in times.items()), flush=True)


def _sha(tensors) -> str:
    return hashlib.sha256(_bits(tensors)).hexdigest()


def fill_card(margin: int) -> list:
    """Hold device memory until ``margin`` bytes are left free on the card,
    in 64 MiB blocks carved from 1 GiB segments; then free every other
    block of the first segments (up to 2 GiB of holes), so the caching
    allocator holds free blocks inside segments it cannot release. Returns
    the held blocks."""
    piece, seg = 64 << 20, 1 << 30
    held = []
    while torch.cuda.mem_get_info()[0] - seg >= margin:
        torch.empty(seg, dtype=torch.uint8, device="cuda")   # a segment ...
        held += [torch.empty(piece, dtype=torch.uint8, device="cuda")
                 for _ in range(seg // piece)]              # ... carved
    while torch.cuda.mem_get_info()[0] - piece >= margin:
        held.append(torch.empty(piece, dtype=torch.uint8, device="cuda"))
    for i in range(1, min(len(held), 64), 2):
        held[i] = None
    return held


@contextlib.contextmanager
def recorded_convs(records, peak, conv=cnn._Conv):
    """``models.cnn._Conv`` with each call recorded into ``records``, in
    launch order: its name, the sha256 of what it returned, and the bytes
    it held beyond its inputs and outputs while it ran; a profiler range
    ``cnnconv:<name>`` around it. ``peak[0]`` keeps the largest
    ``max_memory_allocated`` seen, which each call resets. Each call is
    synchronized before and after, so that the kernels that run inside
    its range are its own."""
    fwd, bwd = conv.forward, conv.backward
    order = []

    def measured(name, fn, *args):
        base = torch.cuda.memory_allocated()
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with torch.profiler.record_function(f"cnnconv:{name}"):
            out = fn(*args)
            torch.cuda.synchronize()
        outs = [t for t in (out if isinstance(out, tuple) else (out,))
                if t is not None]
        peak[0] = max(peak[0], torch.cuda.max_memory_allocated())
        held = (torch.cuda.max_memory_allocated() - base
                - sum(t.numel() * t.element_size() for t in outs))
        records.append({"name": name, "sha": _sha(outs)[:16],
                        "scratch_mb": round(held / 2 ** 20, 1)})
        return out

    def forward(ctx, x, w):
        i = len(order)
        order.append(i)
        ctx.conv_index = i
        return measured(f"conv{i} fwd {tuple(x.shape)} {w.shape[2]}->"
                        f"{w.shape[3]}", fwd, ctx, x, w)

    def backward(ctx, gy):
        return measured(f"conv{ctx.conv_index} bwd", bwd, ctx, gy)

    conv.forward = staticmethod(forward)
    conv.backward = staticmethod(backward)
    try:
        yield
    finally:
        conv.forward, conv.backward = staticmethod(fwd), staticmethod(bwd)


def _device_events(events) -> list:
    """The CUDA kernels of a profile, in start order (not the ranges'
    own device-side marks)."""
    return sorted((e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.name.startswith("cnnconv:")),
                  key=lambda e: e.time_range.start)


def _kernels_by_range(prof) -> dict:
    """The CUDA kernels that ran inside each ``cnnconv:`` profiler range
    (each range synchronized at both ends, so they are its own)."""
    events = prof.events()
    gpu = _device_events(events)
    out = {}
    for e in events:
        if e.name.startswith("cnnconv:"):
            lo, hi = e.time_range.start, e.time_range.end
            out[e.name[len("cnnconv:"):]] = sorted({
                k.name[:80] for k in gpu
                if lo <= k.time_range.start <= hi})
    return out


def train_step_record(fill_margin=None, arm_name="model") -> dict:
    """One full-width forward and grads step, seeded, its convolutions
    those of ``arm_name``; with ``fill_margin``, the card filled first
    (``fill_card``)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.core.adapters import CNNAdapter
    from repro_torch.optim.api import tree_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = registry.get_config("cifar-cnn")
    adapter = CNNAdapter(cfg, OptimizerConfig())
    g = torch.Generator(device="cuda").manual_seed(0)
    bundle = adapter.init(g)
    batch = {"images": torch.randn(STEP_BATCH, cfg.image_size,
                                   cfg.image_size, 3, generator=g,
                                   device="cuda"),
             "labels": torch.randint(0, cfg.n_classes, (STEP_BATCH,),
                                     generator=g, device="cuda"),
             "aug_seed": 7}
    params = tree_leaves(bundle["params"])
    for t in params:
        t.requires_grad_(True)
    # the cuBLAS (and, for the cuDNN arms, cuDNN) handles of this thread and
    # of autograd's, made before the card is filled: they take memory
    # outside PyTorch's allocator. Other shapes than the step's, so no
    # convolution's choice is made here
    with arm(arm_name):
        a = torch.ones(2, 4, 4, 2, device="cuda", requires_grad=True)
        w = torch.ones(3, 3, 2, 2, device="cuda", requires_grad=True)
        (cnn._conv(a, w).sum() + (a.view(16, 4) @ w.view(9, 4).t()).sum()
         ).backward()
    torch.cuda.synchronize()
    held = fill_card(fill_margin) if fill_margin is not None else []
    free = torch.cuda.mem_get_info()[0]
    base = torch.cuda.memory_allocated()
    records, peak = [], [0]
    torch.cuda.reset_peak_memory_stats()
    with arm(arm_name), recorded_convs(records, peak, conv_class(arm_name)), \
            torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        loss, (_, new_state) = adapter._loss(bundle["params"],
                                             bundle["state"], batch)
        grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
    peak = max(peak[0], torch.cuda.max_memory_allocated()) - base
    kernels = _kernels_by_range(prof)
    seq = [e.name[:80] for e in _device_events(prof.events())]
    for r in records:
        r["kernels"] = kernels.get(r["name"], [])
    del held
    return {"loss": _sha([loss])[:16], "grads": _sha(grads)[:16],
            "state": _sha(tree_leaves(new_state))[:16],
            "loss_value": loss.item(), "peak_mb": round(peak / 2 ** 20, 1),
            "free_mb_before": round(free / 2 ** 20, 1), "convs": records,
            "kernel_sequence": seq}


def step_child(margin_mb, arm_name) -> None:
    rec = train_step_record(None if margin_mb is None
                            else int(margin_mb * 2 ** 20), arm_name)
    print(json.dumps(rec))


def pressure_margin_mb(fresh: dict) -> float:
    """The free memory ``chip_smoke.py``'s check leaves: the fresh step's
    peak, less its largest convolution scratch, plus ``SCRATCH_MB``."""
    scratch = max(c["scratch_mb"] for c in fresh["convs"])
    return round(fresh["peak_mb"] - scratch + SCRATCH_MB, 1)


def _run_step_child(margin_mb=None, arm_name="model") -> dict:
    cmd = [sys.executable, __file__, "--step-child", "--arm", arm_name]
    if margin_mb is not None:
        cmd += ["--margin-mb", str(margin_mb)]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT,
                          timeout=600)
    if proc.returncode:
        return {"failed": proc.stderr.strip().splitlines()[-1][:300]}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def compare_steps(a: dict, b: dict) -> str:
    """Whether two step records are bitwise equal, and where they part."""
    if "failed" in b:
        return f"the step failed: {b['failed']}"
    same = all(a[k] == b[k] for k in ("loss", "grads", "state"))
    first = next((x["name"] for x, y in zip(a["convs"], b["convs"])
                  if x["sha"] != y["sha"]), None)
    moved = [x["name"] for x, y in zip(a["convs"], b["convs"])
             if x["kernels"] != y["kernels"]]
    seq_a, seq_b = a["kernel_sequence"], b["kernel_sequence"]
    at = next((i for i, (x, y) in enumerate(zip(seq_a, seq_b)) if x != y),
              None if len(seq_a) == len(seq_b) else min(map(len, (seq_a,
                                                                  seq_b))))
    where = ("none" if at is None else
             f"kernel {at} of {len(seq_a)}: {seq_a[at:at + 1]} -> "
             f"{seq_b[at:at + 1]}")
    return (f"loss, grads and new BN state bitwise {same}; first convolution "
            f"whose bits part: {first}; convolutions whose kernels changed: "
            f"{moved or 'none'}; first difference in the step's kernel "
            f"sequence: {where}")


def pressure(margins, arm_name) -> None:
    fresh = _run_step_child(arm_name=arm_name)
    if "failed" in fresh:
        sys.exit(f"the fresh step failed: {fresh['failed']}")
    print(f"[pressure] arm {arm_name}, fresh process: step peak "
          f"{fresh['peak_mb']} MB beyond params and batch, loss "
          f"{fresh['loss_value']!r}", flush=True)
    for c in fresh["convs"]:
        print(f"[pressure]   {c['name']}: scratch {c['scratch_mb']} MB, "
              f"kernels {c['kernels']}", flush=True)
    levels = [(round(fresh["peak_mb"] * f), f"{f} x the fresh step's peak")
              for f in margins]
    levels.append((pressure_margin_mb(fresh), "chip_smoke's margin"))
    for margin, what in levels:
        got = _run_step_child(margin, arm_name)
        print(f"[pressure] arm {arm_name}, card filled to {margin} MB free "
              f"({what}): {compare_steps(fresh, got)}", flush=True)
        for x, y in zip(fresh["convs"], got.get("convs", [])):
            if x["sha"] != y["sha"] or x["kernels"] != y["kernels"]:
                print(f"[pressure]   {y['name']}: scratch {y['scratch_mb']}"
                      f" MB (fresh {x['scratch_mb']}), kernels "
                      f"{y['kernels']}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--child", choices=ARMS)
    ap.add_argument("--pressure", action="store_true")
    ap.add_argument("--arm", choices=ARMS, default="model")
    ap.add_argument("--margins", default="1.5,0.8")
    ap.add_argument("--step-child", action="store_true")
    ap.add_argument("--margin-mb", type=float)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("cnn_determinism.py needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.child:
        child(args.child, args.steps)
        return
    if args.step_child:
        step_child(args.margin_mb, args.arm)
        return
    from repro_torch.configs import registry
    cfg = registry.get_config("cifar-cnn")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    if args.pressure:
        pressure([float(m) for m in args.margins.split(",")], args.arm)
        return
    in_process(cfg, args.batch)
    across_processes(args.steps)
    step_ms(cfg)


if __name__ == "__main__":
    main()
