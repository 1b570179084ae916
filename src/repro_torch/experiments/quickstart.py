"""Quickstart: the complete SWAP pipeline on the port. Twin of
``examples/quickstart.py``.

Trains the paper-faithful CNN+BatchNorm on the synthetic image task with
all three phases, prints per-phase results, and shows the averaged model
beating its workers.

  PYTHONPATH=src python -m repro_torch.experiments.quickstart \
      [--device {cuda,cpu}]
"""
import argparse

import torch

from repro_torch.configs import registry
from repro_torch.configs.base import (OptimizerConfig, PhaseConfig,
                                      ScheduleConfig, SWAPConfig)
from repro_torch.core import SWAP, CNNAdapter
from repro_torch.data.pipeline import Loader, make_gmm_images
from repro_torch.kernels.dispatch import require_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    dev = require_device(ap.parse_args(argv).device)

    # 1. data: finite synthetic train set + held-out test set
    data = make_gmm_images(seed=0, n_classes=10, image_size=16,
                           n_train=2048, n_test=1024, noise=3.5)
    train = {"images": data["train_images"], "labels": data["train_labels"]}
    test_loader = Loader({"images": data["test_images"],
                          "labels": data["test_labels"]}, 256, device=dev)

    # 2. model + optimizer (paper: SGD, momentum .9, wd 5e-4)
    adapter = CNNAdapter(registry.get_smoke_config("cifar-cnn"),
                         OptimizerConfig(kind="sgd"))

    # 3. SWAP: large-batch phase until 95% train accuracy, then 4 workers
    cfg = SWAPConfig(
        n_workers=4,
        phase1=PhaseConfig(batch_size=512, max_steps=120, stop_accuracy=0.95,
                           schedule=ScheduleConfig(kind="warmup_linear",
                                                   peak_lr=1.2,
                                                   warmup_steps=24,
                                                   total_steps=120)),
        phase2=PhaseConfig(batch_size=64, max_steps=48,
                           schedule=ScheduleConfig(kind="warmup_linear",
                                                   peak_lr=0.1, warmup_steps=0,
                                                   total_steps=48)))
    res = SWAP(adapter, cfg, train, test_loader).run(
        torch.Generator(device=dev).manual_seed(0))

    print(f"phase 1: {res['phase1_steps']} large-batch steps "
          f"-> test {res['phase1_test_acc']:.3f} "
          f"({res['phase1_time']:.1f}s)")
    print(f"phase 2: {cfg.n_workers} independent workers "
          f"({res['phase2_time']:.1f}s)")
    for w, acc in enumerate(res["worker_test_accs"]):
        print(f"  worker {w}: test {acc:.3f}")
    print(f"phase 3: averaged model -> test {res['after_avg_test_acc']:.3f} "
          f"({res['phase3_time']:.1f}s, BN stats recomputed)")
    gain = res["after_avg_test_acc"] - res["before_avg_test_acc"]
    print(f"averaging gain over mean worker: {gain:+.3f}")
    return res


if __name__ == "__main__":
    main()
