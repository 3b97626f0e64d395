"""The precision a plain reference computes in.

``Arith(torch.float64)`` is the referee.  ``Arith(torch.float32,
tf32=True)`` is the control: the reference in the precision one step below
what the configurations state (float32 with TF32 off), every matrix
product taking its operands rounded to TF32 (10 stored mantissa bits,
round to nearest, ties away, as ``cvt.rna.tf32.f32``) and accumulating in
float32, which is what a TF32 tensor-core product computes.  The rounding
is done here rather than by ``allow_tf32``, whose effect on small batched
products depends on which kernel the library picks."""

from __future__ import annotations

import dataclasses

import torch


def round_tf32(x):
    """float32 values rounded to TF32's 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32).reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class Arith:
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def mm(self, a, b):
        """a @ b, with both operands rounded to TF32 in the control (the
        rounding passes derivatives through unchanged)."""
        if self.tf32:
            a = a + (round_tf32(a.detach()) - a.detach())
            b = b + (round_tf32(b.detach()) - b.detach())
        return torch.matmul(a, b)

    def t(self, x):
        """x in this precision's dtype."""
        return x.to(self.dtype)

