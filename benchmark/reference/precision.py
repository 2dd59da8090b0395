"""Precisions of the plain reference: the reference itself and its controls.

A control is the reference computed one step below the precision a
configuration states, the step a later change might be tempted to take:
TF32 matrix products and convolutions, and bfloat16 elsewhere, below
"exact" float32; scaled float8 (e4m3) below "fast" bfloat16. A control
rounds where the program's precision rounds: the output of each
operation the program runs as a separate step (a matrix product, an
addition, an activation), the parameters where they are cast for use, and
in training the gradient flowing back through each of those points.
Operations the program fuses into one kernel that accumulates in float32
(the aggregations, the attention's softmax and weighted sum) round once,
at their output.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

_FP8_MAX = 448.0          # largest finite float8 e4m3fn


def _to_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _to_fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3, as a float8 path stores a tensor."""
    scale = x.abs().amax().clamp_min(1e-30) / _FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Round(torch.autograd.Function):
    """Rounds a value in the forward pass and its gradient in the backward
    pass, as a path storing both in the lower precision does."""

    @staticmethod
    def forward(ctx, x, fn):
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.fn(grad), None


@dataclasses.dataclass(frozen=True)
class Precision:
    """`dtype`: the dtype computed in. `tf32`: matrix products and
    convolutions in TF32. `store`: what values are rounded to where the
    program would store them (None, "bf16" or "fp8")."""

    name: str
    dtype: torch.dtype = torch.float64
    tf32: bool = False
    store: str | None = None

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """x as the precision stores it where the program stores a value
        (each operation's output, the parameters at use); its gradient
        likewise."""
        if self.store is None or not x.is_floating_point():
            return x
        fn = {"bf16": _to_bf16, "fp8": _to_fp8}[self.store]
        return _Round.apply(x, fn)

    @contextlib.contextmanager
    def math(self):
        """TF32 for matrix products and convolutions as this precision says,
        the flags restored afterwards."""
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        torch.backends.cudnn.allow_tf32 = self.tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags


REFERENCE = Precision("reference", torch.float64)
REFERENCE_F32 = Precision("reference_f32", torch.float32)
# below "exact" (float32, TF32 off)
CONTROL_EXACT = Precision("control_tf32_bf16", torch.float32, tf32=True, store="bf16")
# below "fast" (bfloat16)
CONTROL_FAST = Precision("control_fp8", torch.float32, store="fp8")


def control_for(program_precision: str) -> Precision:
    return {"exact": CONTROL_EXACT, "fast": CONTROL_FAST}[program_precision]
