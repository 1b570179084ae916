#!/usr/bin/env python3
"""How far the CNN's f32 gradients on the card lie from f64, and whether a
convolution route or the model's branch puts them there.

    python3 cnn_conv_accuracy.py [--batch 32] [--routes a,b,...]

At the full width of cifar-cnn ``config()`` (random weights and images
from a seed, train mode, the loss sum(logits * cotangent)):

1. the whole-model grads on the CPU in f32 and on the card with each
   route below, each leaf's max |err| / max |ref| against the CPU in f64,
   and against the CPU in f64 on the f32 run's own branch: the ReLU masks
   and the 2x2 and global max choices of the f32 forward replayed in f64
   (``Branch``), so that a choice that flips between f32 and f64 (a
   pre-activation within rounding of 0, a near-tie of a max) does not
   count as rounding error; the flips are counted;
2. for each convolution, its backward (dx, dw) alone on the inputs and the
   cotangent the card's model gave it, by each route, against the CPU in
   f64 on the same inputs;
3. the kernels each convolution's backward launches on cuDNN
   (torch.profiler) and each route's time at the batch of 512 that Table
   1's phase 1 runs.

Routes: ``model`` (``models.cnn``'s own: im2col products over slices of
``cnn._SLICE`` images), ``cudnn`` (cuDNN's convolution backward in f32,
the port's earlier route took it under ``deterministic``),
``cudnn-benchmark`` and ``cudnn-deterministic`` (the same call under
those flags),
``cudnn-nchw`` (NCHW-contiguous operands), ``native`` (cuDNN off:
PyTorch's own CUDA convolution), ``gemm`` (im2col and f32 matmuls).
Needs a card. ``chip_smoke.py`` holds the port against f64 with
``Branch`` and ``cnn_grads``.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.models import cnn  # noqa: E402
from repro_torch.optim.api import tree_leaves, tree_map  # noqa: E402


class Branch:
    """The piecewise choices of a CNN forward: ReLU masks and the 2x2 and
    global max argmaxes, recorded (``"record"``: the forward stays the
    model's own, bit for bit) or imposed on another forward (``"replay"``)
    while ``patched()`` is open."""

    def __init__(self, mode: str, choices=None):
        self.mode, self.choices, self.i = mode, choices or [], 0
        self._model = torch.relu, torch.amax, cnn._maxpool

    def _take(self, kind, make, device):
        """The replayed choice on ``device``; or None, having recorded
        ``make()``."""
        if self.mode == "replay":
            k, c = self.choices[self.i]
            assert k == kind, (k, kind)
            self.i += 1
            return c.to(device)
        self.choices.append((kind, make().cpu()))
        return None

    def relu(self, y):
        m = self._take("relu", lambda: y > 0, y.device)
        return self._model[0](y) if m is None else y * m.to(y.dtype)

    def maxpool(self, x):
        xs = cnn._nchw(x)
        idx = self._take("pool", lambda: F.max_pool2d(
            xs, 2, return_indices=True)[1], x.device)
        if idx is None:
            return self._model[2](x)
        return cnn._nhwc(xs.flatten(2).gather(2, idx.flatten(2)).view(
            idx.shape))

    def amax(self, h, dim):
        flat = h.flatten(1, 2)
        idx = self._take("amax", lambda: flat.argmax(1), h.device)
        if idx is None:
            return self._model[1](h, dim=dim)
        return flat.gather(1, idx[:, None, :]).squeeze(1)

    @contextlib.contextmanager
    def patched(self):
        torch.relu, torch.amax, cnn._maxpool = (self.relu, self.amax,
                                                self.maxpool)
        try:
            yield
        finally:
            torch.relu, torch.amax, cnn._maxpool = self._model

    def flips(self, other: "Branch") -> dict:
        """How many choices differ from ``other``'s, by kind."""
        out = {}
        for (k, a), (_, b) in zip(self.choices, other.choices):
            out[k] = out.get(k, 0) + int((a != b).sum())
        return out


def cnn_grads(params, state, x, cot, cfg, dev, dtype=torch.float32,
              branch=None, conv=None, convs=None):
    """``apply_cnn`` (train mode) on ``dev`` in ``dtype`` and the grads of
    sum(logits * cot), under ``branch`` if given and with ``conv`` in
    place of ``cnn._conv`` if given. Appends each convolution's [input,
    weight, output cotangent] to ``convs`` if given. Returns (logits and
    new BN state leaves, grads), on the CPU, grads in f64."""
    p = tree_map(lambda t: t.to(dev, dtype).requires_grad_(), params)
    s = tree_map(lambda t: t.to(dev, dtype), state)
    inner = conv or cnn._conv

    def conv_rec(h, w):
        y = inner(h, w)
        if convs is not None:
            rec = [h.detach(), w.detach(), None]
            convs.append(rec)
            y.register_hook(lambda gy: rec.__setitem__(2, gy))
        return y

    old = cnn._conv
    cnn._conv = conv_rec
    try:
        with branch.patched() if branch else contextlib.nullcontext():
            logits, new_state = cnn.apply_cnn(p, s, x.to(dev, dtype), cfg,
                                              train=True)
    finally:
        cnn._conv = old
    grads = torch.autograd.grad((logits * cot.to(dev, dtype)).sum(),
                                tree_leaves(p))
    return ([t.detach().cpu() for t in [logits] + tree_leaves(new_state)],
            [t.cpu().double() for t in grads])


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in f64."""
    got, want = got.cpu().double(), want.cpu().double()
    return ((got - want).abs().max() / want.abs().max()).item()


def _im2col(x):
    """(N, H, W, C) -> (N*H*W, 9*C), columns in HWIO's (kh, kw, c) order."""
    N, H, W, C = x.shape
    Hp, Wp = H + 2, W + 2
    cols = F.pad(x, (0, 0, 1, 1, 1, 1)).as_strided(
        (N, H, W, 3, 3, C), (Hp * Wp * C, Wp * C, C, Wp * C, C, 1))
    return cols.reshape(N * H * W, 9 * C)


def bwd_gemm(x, w, gy):
    """dx and dw of the 3x3 SAME convolution by im2col and f32 matmuls."""
    N, H, W, C = x.shape
    O = w.shape[3]
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dw = (_im2col(x).t() @ gy.reshape(-1, O)).reshape(3, 3, C, O)
        wt = w.flip(0, 1).transpose(2, 3).reshape(9 * O, C)
        dx = (_im2col(gy) @ wt).reshape(N, H, W, C)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return dx, dw


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full f32 inside the block, whatever the global
    ``torch.backends.cudnn.allow_tf32`` says."""
    conv = torch.backends.cudnn.conv
    old = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = old


def bwd_cudnn(x, w, gy, nchw=False, **flags):
    """dx and dw as ``cnn._Conv.backward`` takes them, under cuDNN
    ``flags``; ``nchw`` makes the operands NCHW-contiguous."""
    xs, gs = cnn._nchw(x), cnn._nchw(gy)
    wk = w.permute(3, 2, 0, 1)
    if nchw:
        xs, gs, wk = xs.contiguous(), gs.contiguous(), wk.contiguous()
    with torch.backends.cudnn.flags(**{
            "enabled": True, "benchmark": False, "deterministic": False,
            "allow_tf32": False, **flags}), _no_tf32():
        gx, gw, _ = torch.ops.aten.convolution_backward(
            gs, xs, wk, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, True, False])
    return cnn._nhwc(gx), gw.permute(2, 3, 1, 0)


def bwd_model(x, w, gy):
    """dx and dw as ``models.cnn``'s own convolution takes them."""
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    return torch.autograd.grad(cnn._conv(xs, ws), (xs, ws), gy)


ROUTES = {
    "model": bwd_model,
    "cudnn": bwd_cudnn,
    "cudnn-benchmark": lambda x, w, g: bwd_cudnn(x, w, g, benchmark=True),
    "cudnn-deterministic": lambda x, w, g: bwd_cudnn(x, w, g,
                                                     deterministic=True),
    "cudnn-nchw": lambda x, w, g: bwd_cudnn(x, w, g, nchw=True),
    "native": lambda x, w, g: bwd_cudnn(x, w, g, enabled=False),
    "gemm": bwd_gemm,
}


def routed(route: str):
    """``cnn._conv`` with its backward taken by ``ROUTES[route]``."""
    class Routed(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            return cnn._Conv.forward(ctx, x, w)        # saves (x, w)

        @staticmethod
        def backward(ctx, gy):
            return ROUTES[route](*ctx.saved_tensors, gy)

    return Routed.apply


def _leaf_names(params):
    return [f"{k}/{j}" for k in sorted(params) for j in sorted(params[k])]


def _device_ms(fn, iters=10) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main() -> None:
    from repro_torch.configs import registry
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--routes", default=",".join(ROUTES))
    ap.add_argument("--seed", type=int, default=21)
    args = ap.parse_args()
    routes = args.routes.split(",")
    cfg = registry.get_config("cifar-cnn")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    params, state = cnn.init_cnn(g, cfg)
    x = torch.randn(args.batch, cfg.image_size, cfg.image_size, 3,
                    generator=g, device="cuda")
    cot = torch.randn(args.batch, cfg.n_classes, generator=g, device="cuda")
    names = _leaf_names(params)
    model = (params, state, x, cot, cfg)

    b64 = Branch("record")
    f64 = cnn_grads(*model, "cpu", torch.float64, branch=b64)[1]
    print(f"cifar-cnn config(), batch {args.batch}, seed {args.seed}: "
          f"whole-model grads, max |err|/max |ref| against the CPU in f64; "
          f"then against f64 on the f32 run's own branch")

    def report(tag, grads, ref):
        errs = sorted(((rel_err(a, b), n) for a, b, n in
                       zip(grads, ref, names)), reverse=True)
        print(f"  {tag:34s} worst {errs[0][0]:.3e}; "
              + ", ".join(f"{n} {e:.2e}" for e, n in errs[:4]), flush=True)

    convs = []

    def run(tag, dev, **kw):
        rec = Branch("record")
        grads = cnn_grads(*model, dev, branch=rec, **kw)[1]
        report(tag, grads, f64)
        ref = cnn_grads(*model, "cpu", torch.float64,
                        branch=Branch("replay", rec.choices))[1]
        report(f"{tag} (f64 on its branch)", grads, ref)
        print(f"    choices that differ from f64's: {rec.flips(b64)}")

    run("cpu f32", "cpu")
    for r in routes:
        run(f"card {r}", "cuda", conv=routed(r),
            convs=convs if r == "model" else None)

    print("each convolution's backward on the card model's own inputs, "
          "max |err|/max |ref| against the CPU in f64 (dx, dw)")
    tags = [f"{tuple(xs.shape)} {w.shape[2]}->{w.shape[3]}"
            for xs, w, _ in convs]
    for (xs, w, gy), tag in zip(convs, tags):
        want = bwd_cudnn(xs.cpu().double(), w.cpu().double(),
                         gy.cpu().double())
        row = []
        for r in ["cpu-f32"] + routes:
            got = (bwd_cudnn(xs.cpu(), w.cpu(), gy.cpu()) if r == "cpu-f32"
                   else ROUTES[r](xs, w, gy))
            row.append(f"{r} {rel_err(got[0], want[0]):.2e}/"
                       f"{rel_err(got[1], want[1]):.2e}")
        print(f"  {tag}: " + "; ".join(row), flush=True)

    scale = 512 // args.batch
    print(f"kernels of each convolution's backward (route cudnn) and each "
          f"route's ms at batch {args.batch * scale} (CUDA events, mean of "
          f"10)")
    total = dict.fromkeys(routes, 0.0)
    for (xs, w, gy), tag in zip(convs, tags):
        xb, gb = xs.repeat(scale, 1, 1, 1), gy.repeat(scale, 1, 1, 1)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            bwd_cudnn(xb, w, gb)
            torch.cuda.synchronize()
        kern = sorted({e.name[:60] for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA})
        times = []
        for r in routes:
            ms = _device_ms(lambda: ROUTES[r](xb, w, gb))
            total[r] += ms
            times.append(f"{r} {ms:.3f}")
        print(f"  {tag} x{scale}: " + "; ".join(times))
        print(f"    cudnn kernels: {kern}", flush=True)
    print("  sum over the 8 convolutions: "
          + "; ".join(f"{r} {t:.3f} ms" for r, t in total.items()))


if __name__ == "__main__":
    main()
