"""Public streaming-average op, one tensor or a tree of them.

Twin of ``repro/kernels/swa_avg/ops.py``. ``impl="auto"`` (the default)
resolves with ``repro_torch.kernels.dispatch``: the hand-written kernel on
CUDA, the plain version on the CPU. Both compute
``avg + (w - avg) / (n + 1)`` with a true divide, so they are bitwise equal.
``inplace=True`` writes the result into ``avg`` (the kernel's output may
alias its input), which keeps a full-width fold to the one accumulator.
"""
from __future__ import annotations

from repro_torch.kernels import dispatch
from repro_torch.kernels.swa_avg import kernel as _kernel
from repro_torch.kernels.swa_avg.ref import running_average_ref


def running_average(avg, w, n, *, impl: str = "auto", inplace: bool = False):
    """avg' = avg + (w - avg)/(n+1) for one tensor."""
    which = dispatch.resolve(impl, avg.device)
    if which == "kernel":
        return _kernel.running_average(avg.contiguous(), w.contiguous(), n,
                                       out=avg if inplace else None)
    out = running_average_ref(avg, w, n)
    return avg.copy_(out) if inplace else out


def running_average_tree(avg_tree, w_tree, n, *, impl: str = "auto",
                         inplace: bool = False):
    """Streaming average applied leaf-wise to nested dicts of tensors."""
    if isinstance(avg_tree, dict):
        return {k: running_average_tree(avg_tree[k], w_tree[k], n, impl=impl,
                                        inplace=inplace)
                for k in avg_tree}
    return running_average(avg_tree, w_tree, n, impl=impl, inplace=inplace)
