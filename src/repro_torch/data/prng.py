"""Threefry-2x32 counter-based PRNG: a twin of ``jax.random``.

The port's data pipeline must give the JAX package's batches, so it needs
the same random bits from the same seed. This module recomputes them on
the CPU (numpy for the integer hash, torch for the floats), following
``jax.random`` with ``jax_threefry_partitionable=True`` (the default
since JAX 0.5):

  * a key is an int64 tensor of shape (..., 2) holding two uint32 words;
  * ``fold_in``, ``split`` and ``bits`` hash a 64-bit iota (two 32-bit
    words) under the key with Threefry-2x32 (20 rounds);
  * ``uniform`` puts 23 random bits in the mantissa of a float in [1, 2);
  * ``normal`` is ``sqrt(2) * erfinv(u)`` with XLA's f32 polynomial for
    erfinv; ``categorical`` takes the argmax of gumbel noise plus the
    logits (mode "low"); ``permutation`` sorts by fresh 32-bit keys for
    ceil(3 ln n / ln(2^32 - 1)) rounds.

By default the hash runs on the host in numpy ``uint32`` (torch has no full
uint32 arithmetic), in place, over chunks of the counter that stay in the
CPU's cache. ``uniform`` and ``normal`` also take ``device=``: the hash
then runs in torch int64 ops (each word masked to 32 bits) on that device,
as ``jax.random`` runs on its accelerator, and gives the same bits as the
host path; the floats that follow are the same torch ops either way, so on
the CPU the two paths are bitwise equal. A key that lives on an
accelerator is hashed there with its words read on the device (``split``,
and the float draws with ``device=``), never on the host. Keys and
integer results are handed out as int64 tensors holding the uint32 values.
Integer outputs are bitwise equal to JAX's; ``uniform`` is too; ``normal``
and ``categorical``'s noise pass through ``log``/``log1p``/``sqrt`` of
another library and agree to a few ulp. ``permutation`` uses a stable sort
where XLA's is not promised to be stable: the two agree unless two of the
32-bit sort keys tie.
"""
from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_CHUNK = 1 << 16          # counters hashed at a time (fits in L2)
Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


def _words(key):
    """The key's two words: Python ints, or, for a key on an accelerator,
    0-d tensors there, so that a hash under it needs no host read (and can
    be captured in a CUDA graph)."""
    if isinstance(key, torch.Tensor) and key.device.type != "cpu":
        return key[0], key[1]
    return int(key[0]) & M32, int(key[1]) & M32


def threefry2x32(k1: int, k2: int, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash of uint32 counts (x1, x2) under the key
    words (k1, k2). Overwrites and returns x1 and x2."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    tmp = np.empty_like(x2)
    x1 += np.uint32(ks[0])
    x2 += np.uint32(ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 += x2
            np.left_shift(x2, r, out=tmp)        # rotate left by r
            x2 >>= np.uint32(32 - r)
            x2 |= tmp
            x2 ^= x1
        x1 += np.uint32(ks[(i + 1) % 3])
        x2 += np.uint32((ks[(i + 2) % 3] + i + 1) & M32)
    return x1, x2


def _threefry2x32_torch(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """``threefry2x32`` on int64 tensors holding uint32 values, on their
    device, under key words that are ints or 0-d int64 tensors there.
    Overwrites and returns x1 and x2."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    tmp = torch.empty_like(x2)
    x1.add_(ks[0]).bitwise_and_(M32)
    x2.add_(ks[1]).bitwise_and_(M32)
    for i in range(5):
        for r in _ROT[i % 2]:
            x1.add_(x2).bitwise_and_(M32)
            torch.bitwise_left_shift(x2, r, out=tmp)     # rotate left by r
            x2.bitwise_right_shift_(32 - r).bitwise_or_(tmp)
            x2.bitwise_and_(M32).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        x2.add_((ks[(i + 2) % 3] + i + 1) & M32).bitwise_and_(M32)
    return x1, x2


def PRNGKey(seed: int) -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` for 0 <= seed < 2**31."""
    seed = int(seed)
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed must be in [0, 2**31), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64)


def _hash_iota(key, n: int):
    """Threefry of the 64-bit iota 0..n-1 (n < 2**32: the high word is 0),
    as two uint32 arrays."""
    k1, k2 = _words(key)
    b1 = np.zeros(n, dtype=np.uint32)
    b2 = np.arange(n, dtype=np.uint32)
    for i in range(0, n, _CHUNK):
        threefry2x32(k1, k2, b1[i:i + _CHUNK], b2[i:i + _CHUNK])
    return b1, b2


def _key(b1, b2) -> torch.Tensor:
    return torch.from_numpy(np.stack([b1, b2], axis=-1).astype(np.int64))


def fold_in(key, data: int) -> torch.Tensor:
    b1, b2 = threefry2x32(*_words(key), np.zeros(1, np.uint32),
                          np.array([int(data) & M32], np.uint32))
    return _key(b1, b2)[0]


def split(key, num: int = 2) -> torch.Tensor:
    """``num`` new keys, shape (num, 2). A key on an accelerator is split
    there, in torch int64 ops, and the keys stay there."""
    if isinstance(key, torch.Tensor) and key.device.type != "cpu":
        b1 = torch.zeros(num, dtype=torch.int64, device=key.device)
        b2 = torch.arange(num, dtype=torch.int64, device=key.device)
        return torch.stack(_threefry2x32_torch(*_words(key), b1, b2), dim=-1)
    return _key(*_hash_iota(key, num))


def _bits32(key, shape: Shape, device=None):
    """32 random bits per element: a numpy uint32 array (``device`` None),
    or an int64 tensor on ``device``."""
    shape = _shape(shape)
    n = math.prod(shape)
    if device is None:
        b1, b2 = _hash_iota(key, n)
        b1 ^= b2
        return b1.reshape(shape)
    b1 = torch.zeros(n, dtype=torch.int64, device=device)
    b2 = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32_torch(*_words(key), b1, b2)
    return b1.bitwise_xor_(b2).reshape(shape)


def bits(key, shape: Shape) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32 values)."""
    return torch.from_numpy(_bits32(key, shape).astype(np.int64))


def _bits_to_unit(b) -> torch.Tensor:
    """uint32 bits -> f32 in [0, 1): 23 bits in the mantissa of [1, 2)."""
    if isinstance(b, torch.Tensor):
        b = b.bitwise_right_shift_(9).bitwise_or_(0x3F800000)
        return b.to(torch.int32).view(torch.float32) - 1.0
    b >>= np.uint32(9)
    b |= np.uint32(0x3F800000)
    return torch.from_numpy(b.view(np.float32)) - 1.0


def uniform(key, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    f = _bits_to_unit(_bits32(key, shape, device))
    return torch.maximum(lo, f * (hi - lo) + lo)


# XLA's f32 erfinv (Giles, "Approximating the erfinv function")
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


@functools.cache
def _erfinv_coefs(device: torch.device):
    """The two polynomials' coefficients as f32 tensors on ``device``,
    copied there once."""
    return [torch.tensor(c, dtype=torch.float32, device=device)
            for c in _ERFINV_LT5 + _ERFINV_GE5]


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """f32 erfinv by XLA's polynomial, op for op."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coefs = _erfinv_coefs(x.device)
    n = len(_ERFINV_LT5)
    p = torch.where(lt, coefs[0], coefs[n])
    for a, b in zip(coefs[1:n], coefs[n + 1:]):
        p = torch.where(lt, a, b) + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       out)


def normal(key, shape: Shape = (), device=None) -> torch.Tensor:
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return torch.tensor(math.sqrt(2), dtype=torch.float32) * erfinv(u)


def gumbel(key, shape: Shape, device=None) -> torch.Tensor:
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0, device)))


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """One sample per row of ``logits`` (f32) along ``axis``."""
    return torch.argmax(gumbel(key, tuple(logits.shape)) + logits, dim=axis)


def randint(key, shape: Shape, minval: int, maxval: int) -> torch.Tensor:
    """int32 samples in [minval, maxval) by JAX's two-word modulus."""
    k1, k2 = split(key)
    hi, lo = bits(k1, shape), bits(k2, shape)
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & M32) % span
    off = (((hi % span) * mult) & M32) + (lo % span)
    off = (off & M32) % span
    return (minval + off).to(torch.int32)


def permutation(key, n: int) -> torch.Tensor:
    """A shuffle of arange(n) (int32), sorting by 32-bit keys."""
    x = torch.arange(n, dtype=torch.int32)
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(M32))
    for _ in range(rounds):
        key, sub = split(key)
        order = np.argsort(_bits32(sub, (n,)), kind="stable")
        x = x[torch.from_numpy(order)]
    return x
