"""Plain version of the streaming weight average:
avg' = avg + (w - avg) / (n + 1), in f32, rounded to avg's dtype.

Twin of ``repro/kernels/swa_avg/ref.py``; the kernel (``kernel.py``) is held
to it bit for bit. Exactly the arithmetic mean of the n + 1 models seen.
"""
import torch


def running_average_ref(avg, w, n):
    """avg, w: same-shape tensors; n: count of models already in avg."""
    nf = torch.tensor(n, dtype=torch.float32, device=avg.device)
    a = avg.float()
    return (a + (w.float() - a) / (nf + 1.0)).to(avg.dtype)
