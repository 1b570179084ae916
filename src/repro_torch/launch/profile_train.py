"""Where a SWAP training step's time goes, on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile_train --full \
      --workers 2 --elastic-deadline 30 --json-out results/profile.json

Takes the training launcher's flags (``repro_torch.launch.train``) and
builds the same run from them (``train.build``): model, Markov data,
optimizer and phase schedules. It then runs the first steps of each phase
instead of the whole schedule. For phase 1 (one model at the large batch)
and phase 2 (the stacked W-worker ensemble at the small batch):

  * runs WARMUP steps, then times STEPS steps on the host clock, each
    ending in ``torch.cuda.synchronize()``: ms per step, and tokens/s as
    the tokens of the timed steps over their total time;
  * traces TRACED more steps with ``torch.profiler`` and sums the device
    time of every kernel by category (matmul, each hand-written kernel,
    everything else), and the device's idle share of the traced window
    (1 - kernel time / window; it would go negative if kernels on several
    streams overlapped);
  * reads ``torch.cuda.max_memory_allocated()`` over the phase.

Then it times the phase-3 average of the W models, as the run's flags set
it (the elastic fold on the streaming-average kernel with
``--elastic-deadline > 0``). Every number is printed with the card's name
and power limit, and written as JSON to ``--json-out`` when it is given.
Needs a card.

gemma3-1b takes the launcher's cut of its phase-1 batch:
``--arch gemma3-1b --full --workers 2 --phase1-batch 128
--elastic-deadline 30``.

``main(argv, cfg=...)`` (a Python keyword, as for ``train.build``)
profiles that run on another config of the same arch, e.g. mamba2-2.7b at
the depth ``chip_smoke.py`` trains it at:

  PYTHONPATH=src python -c "import dataclasses; \
      from repro_torch.configs import registry; \
      from repro_torch.launch import profile_train as p; \
      p.main(['--arch', 'mamba2-2.7b', '--full', '--workers', '2', \
              '--elastic-deadline', '30'], cfg=dataclasses.replace( \
              registry.get_config('mamba2-2.7b'), n_layers=56))"

and zamba2-7b, the hybrid family, at its cut depth (``chip_smoke.py``'s
ZAMBA_TRAIN_LAYERS: 27 of 81 layers, 4 pattern units of 6 with the shared
attention block before each, and the tail of 3): the same command with
``'--arch', 'zamba2-7b'`` and ``registry.get_config('zamba2-7b'),
n_layers=27``.
"""
from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.launch import train as launcher

WARMUP, STEPS, TRACED = 2, 6, 2
CATEGORIES = (("flash_attention_fwd", ("fa_fwd_kernel",
                                       "fa_fwd_sm90_kernel")),
              ("flash_attention_bwd_dq", ("fa_bwd_dq_kernel",
                                          "fa_bwd_dq_sm90_kernel")),
              ("flash_attention_bwd_dkv", ("fa_bwd_dkv_kernel",
                                           "fa_bwd_dkv_sm90_kernel")),
              ("flash_attention_bwd_delta", ("fa_bwd_delta_kernel",)),
              ("flash_attention_bwd_dqkv", ("fa_bwd_dqkv_sm90_kernel",)),
              ("swa_avg", ("avg_kernel",)),
              ("ssd_fwd", ("ssd_fwd_kernel", "ssd_fwd_sm90_kernel")),
              ("ssd_bwd", ("ssd_bwd_kernel", "ssd_bwd_sm90_kernel")),
              # cuDNN's convolutions (the CNN) before the matmul keys,
              # since some of their names hold "sm90_xmma" too
              ("convolution", ("fprop", "dgrad", "wgrad", "implicit_gemm",
                               "implicit_conv", "convolve", "cudnn")),
              ("matmul", ("gemm", "sm90_xmma", "cutlass", "nvjet",
                          "ampere_", "sm80_")))


def _category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def _time_us(evt, names) -> float:
    for attr in names:
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _measure(run_step, tokens_per_step: int, counts=(WARMUP, STEPS, TRACED)):
    """Host-timed steps, then a profiler window of traced steps; ``counts``
    are (warm-up, timed, traced) steps."""
    warmup, steps, traced = counts
    for _ in range(warmup):
        run_step()
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(traced):
            run_step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3 / traced
    by_cat, by_kernel, host_ops = {}, {}, {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            host_ops[evt.key] = (
                evt.self_cpu_time_total / 1e3 / traced,
                _time_us(evt, ("device_time_total", "cuda_time_total"))
                / 1e3 / traced, evt.count // traced)
            continue
        ms = _time_us(evt, ("self_device_time_total",
                            "self_cuda_time_total")) / 1e3 / traced
        by_kernel[evt.key] = by_kernel.get(evt.key, 0.0) + ms
        cat = _category(evt.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + ms
    busy_ms = sum(by_cat.values())
    total_s = sum(times)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    host_top = sorted(host_ops.items(), key=lambda kv: -kv[1][0])[:12]
    dev_top = sorted(host_ops.items(), key=lambda kv: -kv[1][1])[:40]
    return {
        "step_ms": [t * 1e3 for t in times],
        "step_ms_mean": total_s * 1e3 / steps,
        "tokens_per_s": tokens_per_step * steps / total_s,
        "traced_window_ms_per_step": window_ms,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1 - busy_ms / window_ms,
        "device_ms_per_step_by_category": dict(sorted(by_cat.items())),
        "top_kernels_ms_per_step": {k[:120]: v for k, v in top},
        # host ops: (self host ms, device ms of the kernels they launch,
        # calls), per step
        "top_host_ops_by_host_ms": {k[:80]: v for k, v in host_top},
        "top_host_ops_by_device_ms": {k[:80]: v for k, v in dev_top},
    }


def main(argv=None, *, cfg=None, counts=(WARMUP, STEPS, TRACED)):
    """Profile the run that ``argv`` describes (on ``cfg``, as for
    ``train.build``); ``counts``: (warm-up, timed, traced) steps a phase.
    Returns the report."""
    args = launcher.build_parser().parse_args(argv)
    swap = launcher.build(args, cfg)
    dev = torch.device(args.device)
    if dev.type != "cuda":
        raise SystemExit("profile_train times the card: run it with "
                         "--device cuda")
    card = _card()
    cfg, W = swap.adapter.cfg, swap.cfg.n_workers
    report = {"card": card, "arch": cfg.name, "dtype": cfg.dtype,
              "n_layers": cfg.n_layers, "seq_len": args.seq_len,
              "steps": dict(zip(("warmup", "timed", "traced"), counts))}

    torch.cuda.reset_peak_memory_stats(dev)
    bundle = swap.adapter.init(
        torch.Generator(device=dev).manual_seed(args.seed))
    runner, state = swap.phase1(bundle)
    box = [state]

    def phase1_step():
        box[0], _ = runner.run_chunk(box[0], 0, 1)

    report["phase1"] = _measure(phase1_step, args.phase1_batch * args.seq_len,
                                counts)
    report["phase1"].update(batch=args.phase1_batch,
                            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del box[0], state, runner            # the phase-1 optimizer state goes
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)

    runner, state = swap.phase2(bundle)
    box = [state]

    def phase2_step():
        box[0], _ = runner.run_chunk(box[0], list(range(W)), 1)

    report["phase2"] = _measure(phase2_step,
                                W * args.phase2_batch * args.seq_len, counts)
    report["phase2"].update(batch=args.phase2_batch, workers=W,
                            peak_gb=torch.cuda.max_memory_allocated(dev)
                            / 1e9)
    params = box[0].bundle["params"]
    swap.average(params)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    swap.average(params)
    torch.cuda.synchronize()
    report["phase3_average_ms"] = (time.perf_counter() - t0) * 1e3
    report["phase3_elastic"] = swap.dist.elastic

    for ph in ("phase1", "phase2"):
        r = report[ph]
        cats = ", ".join(f"{k} {v:.2f}" for k, v in
                         r["device_ms_per_step_by_category"].items())
        print(f"[profile] {cfg.name} {ph} batch {r['batch']} on {card}: "
              f"{r['step_ms_mean']:.2f} ms/step "
              f"({r['tokens_per_s']:.0f} tok/s), device busy "
              f"{r['device_busy_ms_per_step']:.2f} ms/step, idle share "
              f"{r['device_idle_share']:.3f}, peak {r['peak_gb']:.2f} GB; "
              f"device ms/step by category: {cats}")
    print(f"[profile] phase 3 {'elastic fold' if swap.dist.elastic else 'mean'}"
          f" of {W} models: {report['phase3_average_ms']:.2f} ms")
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
        print(f"[profile] wrote {out}")
    return report


if __name__ == "__main__":
    main()
