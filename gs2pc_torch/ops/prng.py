"""JAX's counter-based random numbers in plain PyTorch (the port's copy of
what ``jax.random`` computes with its default threefry2x32 generator under
``jax_threefry_partitionable``, JAX's default since 0.5).

Every 32-bit random word is a pure function of the key and the word's flat
index ``i`` in the array drawn: ``x0 ^ x1`` of ``threefry2x32(key, (i >>
32, i & 0xFFFFFFFF))``.  So the words of any block ``[lo, hi)`` of a draw
equal the same slice of the whole draw, which is what lets the sampler's
point axis be split over devices (gs2pc_torch.ops.sampler, K5) with no
value changed.

Keys are (2,) int64 CPU tensors holding two uint32 words, as JAX's keys
hold them; draws land on the ``device`` asked for.  Torch has little
uint32 arithmetic, so the words live in int64 and every add and rotate is
masked back to 32 bits.  ``normal`` evaluates XLA's float32 ``erf_inv``
polynomial (``ErfInv32`` in XLA's math library) op by op: on the CPU it
equals JAX's normals within a few float32 ulps (the log1p of the two
libraries may round differently); gs2pc_torch/csrc/sampler.cu repeats the
same operations.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# The lower bound of jax.random.normal's uniform: nextafter(-1, 0) in float32.
NORMAL_LO = -0.99999994
SQRT2_F32 = 1.4142135623730951
# XLA's ErfInv32 coefficients, highest degree first: w = -log1p(-x^2) < 5
# takes the first set at w - 2.5, otherwise the second at sqrt(w) - 3.
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as the JAX package runs it (64-bit types
    off): the pair [0, seed mod 2^32]."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key, x0: torch.Tensor, x1: torch.Tensor) -> tuple:
    """The threefry2x32 block cipher (20 rounds) of the counter words
    (x0, x1) under ``key`` (two uint32 words), elementwise; int64 tensors
    holding uint32 values in and out, or Python integers."""
    k0, k1 = (int(k) & MASK32 for k in key)
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def split(key) -> torch.Tensor:
    """``jax.random.split(key)``: the (2, 2) keys at counters 0 and 1."""
    x0, x1 = threefry2x32(key, torch.zeros(2, dtype=torch.int64), torch.arange(2))
    return torch.stack([x0, x1], dim=1)


def split_words(key) -> tuple:
    """``split(key)`` in Python integers, ((w0, w1), (w0, w1)): no tensor
    op, so a caller that launches on a card does not wait on the host."""
    words = key.tolist() if isinstance(key, torch.Tensor) else list(key)
    return tuple(threefry2x32(words, 0, i) for i in (0, 1))


def random_bits(key, lo: int, hi: int, device=None) -> torch.Tensor:
    """The 32-bit words at flat indices [lo, hi) of any draw under ``key``
    (int64 tensor of uint32 values)."""
    i = torch.arange(lo, hi, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key, i >> 32, i & MASK32)
    return x0 ^ x1


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def uniform(key, lo: int, hi: int, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` at flat
    indices [lo, hi): the top 23 bits as a float in [1, 2), minus 1, scaled
    and shifted in float32, and clamped below at ``minval``."""
    bits = random_bits(key, lo, hi, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    mn, mx = _f32(minval, device), _f32(maxval, device)
    return torch.maximum(mn, f * (mx - mn) + mn)


def erfinv_xla(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function, operation by operation."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    dev = x.device

    def coeff(i):
        return torch.where(lt, _f32(ERFINV_LT5[i], dev), _f32(ERFINV_GE5[i], dev))

    p = coeff(0)
    for i in range(1, len(ERFINV_LT5)):
        p = coeff(i) + p * w
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key, lo: int, hi: int, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` at flat indices [lo, hi):
    sqrt(2) * erfinv of a uniform on [nextafter(-1, 0), 1)."""
    u = uniform(key, lo, hi, NORMAL_LO, 1.0, device)
    return SQRT2_F32 * erfinv_xla(u)
