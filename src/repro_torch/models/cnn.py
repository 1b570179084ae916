"""Paper-faithful CIFAR-analog CNN with BatchNorm: twin of
``repro/models/cnn.py`` (davidcpage/cifar10-fast ResNet9 style, the model
the SWAP paper trains).

Functional, as the reference: params and BN state are nested dicts under
its key paths and shapes (conv weights HWIO), images NHWC. ``apply_cnn``
returns the new running statistics; ``cnn_batch_stats`` collects the raw
per-batch statistics that SWAP's phase 3 turns into running statistics for
the averaged weights (Algorithm 1 line 28 of the paper).

BatchNorm is written as the reference's ops, not ``F.batch_norm``: the
biased batch variance, y = (x - mean) * rsqrt(var + 1e-5) * scale + bias,
and running stats ``0.9 * old + 0.1 * batch``. The convolutions are im2col
products (``_Conv``): each image's 3x3 neighbourhoods as rows, times the
weight, in f32 matmuls in full f32 whatever the caller's
``torch.backends.cuda.matmul`` settings say, over slices of a fixed
``_SLICE`` images. Nothing in them depends on what the process did before:
no algorithm is searched for and no workspace can be missing (cuDNN,
which the port ran before, takes the next engine of its list when a
workspace cannot be had, and so gave other bits in a process whose card
was full; ``cnn_determinism.py --pressure`` shows it), so a run gives the
same bits in every process, which a bit-exact resume in a new process
needs. Against f64 they are closer than cuDNN's f32 convolutions
(``cnn_conv_accuracy.py``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

_EPS = 1e-5
_MOMENTUM = 0.9


# images per slice of the im2col products: a fixed slice keeps every
# product's shape, and so the matmuls' kernels and the order dw sums its
# slices in, the same at every batch and in every process
_SLICE = 64


@contextlib.contextmanager
def _full_f32():
    """f32 matmuls in full f32 inside the block (no TF32). Set through
    ``torch.backends.cuda.matmul.fp32_precision``, which a global
    ``allow_tf32`` or ``set_float32_matmul_precision`` does not override."""
    mm = torch.backends.cuda.matmul
    old = mm.fp32_precision
    mm.fp32_precision = "ieee"
    try:
        yield
    finally:
        mm.fp32_precision = old


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """An NHWC tensor as NCHW with channels-last strides (no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _im2col(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N*H*W, 9*C): each pixel's zero-padded 3x3
    neighbourhood, in HWIO's (kh, kw, c) order."""
    N, H, W, C = x.shape
    Hp, Wp = H + 2, W + 2
    cols = F.pad(x, (0, 0, 1, 1, 1, 1)).as_strided(
        (N, H, W, 3, 3, C), (Hp * Wp * C, Wp * C, C, Wp * C, C, 1))
    return cols.reshape(N * H * W, 9 * C)


def _sliced(a: torch.Tensor, w2: torch.Tensor, out: torch.Tensor) -> None:
    """out = im2col(a) @ w2, ``_SLICE`` images at a time."""
    for i in range(0, a.shape[0], _SLICE):
        torch.matmul(_im2col(a[i:i + _SLICE]), w2,
                     out=out[i:i + _SLICE].view(-1, w2.shape[1]))


class _Conv(torch.autograd.Function):
    """3x3 stride-1 "SAME" convolution of NHWC images with an HWIO weight,
    forward and backward as im2col products in full f32 (see the module
    docstring): y = im2col(x) . w; dx = im2col(dy) . w flipped in space
    with its channels swapped; dw = the sum over slices of im2col(x)^T .
    dy, in slice order."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        N, H, W, C = x.shape
        O = w.shape[3]
        y = x.new_empty(N, H, W, O)
        with _full_f32():
            _sliced(x, w.reshape(9 * C, O), y)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        N, H, W, C = x.shape
        O = w.shape[3]
        gy = gy.contiguous()
        gx = gw = None
        with _full_f32():
            if ctx.needs_input_grad[0]:
                gx = x.new_empty(N, H, W, C)
                _sliced(gy, w.flip(0, 1).transpose(2, 3).reshape(9 * O, C),
                        gx)
            if ctx.needs_input_grad[1]:
                gw = w.new_zeros(9 * C, O)
                for i in range(0, N, _SLICE):
                    gw.addmm_(_im2col(x[i:i + _SLICE]).t(),
                              gy[i:i + _SLICE].reshape(-1, O))
                gw = gw.view(3, 3, C, O)
        return gx, gw


def _conv_init(gen: torch.Generator, shape) -> torch.Tensor:
    fan_in = shape[0] * shape[1] * shape[2]
    return torch.randn(shape, generator=gen, device=gen.device) \
        * (2.0 / fan_in) ** 0.5


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _Conv.apply(x, w)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max pool of NHWC images."""
    return _nhwc(F.max_pool2d(_nchw(x), 2))


def init_cnn(gen: torch.Generator, cfg: ModelConfig):
    """Random (params, state) on ``gen.device``."""
    chans = cfg.cnn_channels
    dev = gen.device
    params, state = {}, {}

    def add_conv_bn(name, cin, cout):
        params[name] = {"w": _conv_init(gen, (3, 3, cin, cout)),
                        "scale": torch.ones(cout, device=dev),
                        "bias": torch.zeros(cout, device=dev)}
        state[name] = {"mean": torch.zeros(cout, device=dev),
                       "var": torch.ones(cout, device=dev)}

    prev = 3
    for i, c in enumerate(chans):
        add_conv_bn(f"conv{i}", prev, c)
        # residual pair on the 2nd and last stages (resnet9 pattern)
        if i in (1, len(chans) - 1):
            add_conv_bn(f"res{i}a", c, c)
            add_conv_bn(f"res{i}b", c, c)
        prev = c
    params["fc"] = {"w": torch.randn(prev, cfg.n_classes, generator=gen,
                                     device=dev) * 0.01}
    return params, state


def _normalize(p, centered, var):
    return centered * torch.rsqrt(var + _EPS) * p["scale"] + p["bias"]


def _bn_batch(p, y: torch.Tensor):
    """BN on the batch's own statistics: (normalized y, mean, biased var)
    over (N, H, W), the variance in two passes as ``jnp.var`` takes it."""
    mean = y.mean(dim=(0, 1, 2))
    centered = y - mean
    var = (centered * centered).mean(dim=(0, 1, 2))
    return _normalize(p, centered, var), mean, var


def _forward(x, cfg: ModelConfig, conv_bn):
    """The network around ``conv_bn(name, h)`` (conv, BN, ReLU), up to the
    global pool."""
    chans = cfg.cnn_channels
    h = x
    for i in range(len(chans)):
        h = conv_bn(f"conv{i}", h)
        if i > 0:
            h = _maxpool(h)
        if i in (1, len(chans) - 1):
            r = conv_bn(f"res{i}a", h)
            r = conv_bn(f"res{i}b", r)
            h = h + r
    return h


def apply_cnn(params, state, x: torch.Tensor, cfg: ModelConfig,
              train: bool):
    """x: (B, H, W, 3). Returns (logits (B, n_classes), new_state): in
    train mode BN normalizes with the batch's statistics and folds them
    into the running ones; in eval mode it uses the running ones."""
    new_state = {}

    def conv_bn(name, h):
        y = _conv(h, params[name]["w"])
        s = state[name]
        if train:
            y, mean, var = _bn_batch(params[name], y)
            new_state[name] = {
                "mean": _MOMENTUM * s["mean"] + (1 - _MOMENTUM) * mean,
                "var": _MOMENTUM * s["var"] + (1 - _MOMENTUM) * var}
        else:
            y = _normalize(params[name], y - s["mean"], s["var"])
            new_state[name] = s
        return torch.relu(y)

    h = _forward(x, cfg, conv_bn)
    h = torch.amax(h, dim=(1, 2))                     # global max pool
    logits = (h @ params["fc"]["w"]) * 0.125          # cifar10-fast scale
    return logits, new_state


def cnn_batch_stats(params, x: torch.Tensor, cfg: ModelConfig):
    """One forward pass collecting raw batch statistics per BN layer, for
    SWAP phase 3 to rebuild running stats for averaged weights."""
    stats = {}

    def conv_bn(name, h):
        y, mean, var = _bn_batch(params[name], _conv(h, params[name]["w"]))
        stats[name] = {"mean": mean, "var": var}
        return torch.relu(y)

    _forward(x, cfg, conv_bn)
    return stats
