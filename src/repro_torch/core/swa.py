"""Sequential SWA baseline (Izmailov et al. 2018) for the Table-4
comparison: cyclic learning rate, one model sampled at each cycle
boundary, streaming average (the swa_avg kernel on CUDA), BN recompute at
the end. Twin of ``repro/core/swa.py``.
"""
from __future__ import annotations

import time
from typing import Dict

from repro_torch.configs.base import SWAConfig
from repro_torch.core.averaging import StreamingAverage
from repro_torch.core.schedules import schedule_fn as make_schedule
from repro_torch.data.pipeline import Loader
from repro_torch.optim.api import tree_leaves
from repro_torch.train.precision import default_scale_state


class SWA:
    def __init__(self, adapter, cfg: SWAConfig, train_arrays: Dict,
                 test_loader: Loader):
        self.adapter = adapter
        self.cfg = cfg
        self.train_arrays = train_arrays
        self.test_loader = test_loader

    def run(self, bundle, opt_state=None) -> Dict:
        """Starts from ``bundle`` (updated in place as it trains)."""
        cfg = self.cfg
        adapter = self.adapter
        dev = tree_leaves(bundle["params"])[0].device
        loader = Loader(self.train_arrays, cfg.batch_size, seed=cfg.seed,
                        device=dev)
        step_fn = adapter.make_train_step(make_schedule(cfg.schedule))
        opt_state = opt_state if opt_state is not None \
            else adapter.init_opt(bundle)
        scale = default_scale_state()   # the SWA baseline trains plain f32

        t0 = time.perf_counter()
        avg = StreamingAverage()
        for step in range(cfg.n_samples * cfg.cycle_steps):
            bundle, opt_state, scale, _ = step_fn(
                bundle, opt_state, loader.batch(step), step, scale)
            if (step + 1) % cfg.cycle_steps == 0:
                avg.add(bundle["params"])
        last_acc = adapter.eval_accuracy(bundle, self.test_loader)
        final = adapter.finalize(avg.value(), loader)
        t1 = time.perf_counter()
        return {
            "before_avg_test_acc": last_acc,
            "after_avg_test_acc": adapter.eval_accuracy(final,
                                                        self.test_loader),
            "time": t1 - t0,
            "n_samples": avg.n,
            "final_bundle": final,
            "last_bundle": bundle,
        }
