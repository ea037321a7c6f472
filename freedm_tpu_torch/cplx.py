"""Complex quantities as (re, im) pairs of real tensors.

The port's counterpart of ``freedm_tpu/utils/cplx.py``: the ladder
power flow, its kernels and the VVC controller carry every phasor as an
explicit pair of real tensors, so the kernels read and write plain
float64 or float32 arrays and ``torch.autograd`` differentiates the
pairs like any other real tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class C(NamedTuple):
    """A complex tensor as a (re, im) pair of equal-shape real tensors."""

    re: Tensor
    im: Tensor

    def __add__(self, o: "C") -> "C":
        return C(self.re + o.re, self.im + o.im)

    def __sub__(self, o: "C") -> "C":
        return C(self.re - o.re, self.im - o.im)

    def __mul__(self, o) -> "C":
        if isinstance(o, C):
            return C(self.re * o.re - self.im * o.im,
                     self.re * o.im + self.im * o.re)
        return C(self.re * o, self.im * o)

    def __truediv__(self, o) -> "C":
        if isinstance(o, C):
            d = o.re * o.re + o.im * o.im
            return C((self.re * o.re + self.im * o.im) / d,
                     (self.im * o.re - self.re * o.im) / d)
        return C(self.re / o, self.im / o)

    def __neg__(self) -> "C":
        return C(-self.re, -self.im)

    def conj(self) -> "C":
        return C(self.re, -self.im)

    def abs2(self) -> Tensor:
        return self.re * self.re + self.im * self.im

    def abs(self) -> Tensor:
        return torch.sqrt(self.abs2())

    def angle(self) -> Tensor:
        return torch.atan2(self.im, self.re)

    def where(self, cond: Tensor, other: float = 0.0) -> "C":
        o = torch.as_tensor(other, dtype=self.re.dtype, device=self.re.device)
        zero = torch.zeros((), dtype=self.re.dtype, device=self.re.device)
        return C(torch.where(cond, self.re, o), torch.where(cond, self.im, zero))

    def sum(self, dim=None) -> "C":
        if dim is None:
            return C(self.re.sum(), self.im.sum())
        return C(self.re.sum(dim=dim), self.im.sum(dim=dim))

    def to_numpy(self) -> np.ndarray:
        """The pair as a host numpy complex array."""
        return (self.re.detach().cpu().numpy()
                + 1j * self.im.detach().cpu().numpy())


def as_c(x, dtype: torch.dtype, device: torch.device) -> C:
    """A :class:`C` pair on ``device`` in ``dtype`` from a ``C`` (or any
    ``(re, im)`` pair), a torch tensor (complex or real) or a numpy
    array-like (complex or real).  Tensors already in place are not
    copied, so gradients flow through the pair."""
    if isinstance(x, tuple) and len(x) == 2:
        re, im = x
        return C(torch.as_tensor(re, dtype=dtype, device=device),
                 torch.as_tensor(im, dtype=dtype, device=device))
    if isinstance(x, Tensor):
        if x.is_complex():
            return C(x.real.to(dtype=dtype, device=device),
                     x.imag.to(dtype=dtype, device=device))
        x = x.to(dtype=dtype, device=device)
        return C(x, torch.zeros_like(x))
    a = np.asarray(x)
    return C(torch.as_tensor(np.array(a.real), dtype=dtype, device=device),
             torch.as_tensor(np.array(a.imag), dtype=dtype, device=device))


def einsum(spec: str, a: C, b: C) -> C:
    """Complex einsum from four real einsums (the reference's order)."""
    rr = torch.einsum(spec, a.re, b.re)
    ii = torch.einsum(spec, a.im, b.im)
    ri = torch.einsum(spec, a.re, b.im)
    ir = torch.einsum(spec, a.im, b.re)
    return C(rr - ii, ri + ir)
