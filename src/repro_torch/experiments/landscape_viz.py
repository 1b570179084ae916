"""Loss-landscape map (paper Figures 2/3): writes the train/test error grid
over the (LB, SGD, SWAP) plane to ``results/figure23_torch.json`` and
draws it as an ASCII heat map. Twin of ``examples/landscape_viz.py``.

  PYTHONPATH=src python -m repro_torch.experiments.landscape_viz \
      [--device {cuda,cpu}]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.experiments.figure23_landscape import run


def ascii_map(grid, key):
    """The grid's ``key`` as rows of characters, high beta at the top."""
    vals = sorted(g[key] for g in grid)
    lo, hi = vals[0], vals[-1]
    chars = " .:-=+*#%@"
    rows = {}
    for g in grid:
        rows.setdefault(round(g["beta"], 6), []).append(g)
    print(f"\n{key} (low '{chars[0]}' ... high '{chars[-1]}'), "
          f"range [{lo:.3f}, {hi:.3f}]")
    for beta in sorted(rows, reverse=True):
        line = ""
        for g in sorted(rows[beta], key=lambda g: g["alpha"]):
            t = (g[key] - lo) / (hi - lo + 1e-12)
            line += chars[min(int(t * (len(chars) - 1)), len(chars) - 1)] * 2
        print(line)


def main(argv=None, *, cfg=None):
    """``cfg``: as for ``figure23_landscape.run``. Returns its result."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    res = run(verbose=True, cfg=cfg, device=args.device)
    path = Path("results/figure23_torch.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1))
    ascii_map(res["grid"], "train_err")
    ascii_map(res["grid"], "test_err")
    print("\npoints:", res["points"])
    return res


if __name__ == "__main__":
    main()
