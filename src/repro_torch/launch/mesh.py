"""The process layout: twin of ``repro/launch/mesh.py``.

The reference lays SWAP out on a device mesh of TPU chips: phase 1 on
``('data', 'model')``, phase 2 on ``('worker', 'data', 'model')``. The port
lays the same axes over the processes of a ``torch.distributed`` run
(``repro_torch.dist.mesh.ProcessMesh``, the worker axis outermost).

The reference's pod shapes (a 16 x 16 TPU v5e pod of 256 chips, two pods
for 512) do not carry over: the helpers here take the processes that
exist. Functions, not module constants: importing this module touches no
process group.
"""
from __future__ import annotations

from repro_torch.dist.mesh import ProcessMesh, world


def make_worker_mesh(n_workers: int = 2) -> ProcessMesh:
    """Phase-2 layout over the processes that exist: ``n_workers`` worker
    blocks of ``world // n_workers`` data ranks each."""
    _, size = world()
    if size % n_workers:
        raise ValueError(f"{n_workers} workers do not split {size} "
                         f"processes into equal blocks")
    return ProcessMesh((n_workers, size // n_workers, 1),
                       ("worker", "data", "model"))


def make_host_mesh(model_parallel: int = 1) -> ProcessMesh:
    """Every process that exists on ``('data', 'model')``."""
    _, size = world()
    model = min(model_parallel, size)
    return ProcessMesh((size // model, model), ("data", "model"))
