"""Where the reference rounds: identity at float32 (the reference itself),
and the lower precisions a control puts in the program's place. A
configuration names its control's precision (`control`), the step below
its own: "fp8" below bfloat16, "bf16" below float32, "tf32" below float32
with TF32 off.

A rounding is applied to the operands of every product and to the pooled
inputs, the points where the program holds its compute dtype; the
gradient that flows back through it is rounded too, as the program's
backward holds its gradients in the compute dtype. The fp8 control is the
usual fp8 recipe: values in float8 e4m3 and gradients in float8 e5m2, one
scale a tensor (its largest magnitude at the format's largest finite
value). TF32 keeps float32's exponent and 10 bits of its mantissa,
rounded to the nearest (ties to even). `round_values` rounds plain values
(a control's metric engine's per-group values) to bfloat16, the step
below float32.
"""
import torch

FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0),
           "e5m2": (torch.float8_e5m2, 57344.0)}


def _fp8(x: torch.Tensor, fmt: str) -> torch.Tensor:
    dtype, top = FORMATS[fmt]
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    i = x.float().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32).to(x.dtype)


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, forward, backward):
        ctx.backward_round = backward
        return forward(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.backward_round(g), None, None


def f32(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Round.apply(x, lambda t: _fp8(t, "e4m3"),
                        lambda t: _fp8(t, "e5m2"))


def bf16(x: torch.Tensor) -> torch.Tensor:
    return _Round.apply(x, _bf16, _bf16)


def tf32(x: torch.Tensor) -> torch.Tensor:
    return _Round.apply(x, _tf32, _tf32)


CASTS = {"f32": f32, "fp8": fp8, "bf16": bf16, "tf32": tf32}
# the precision a control runs a float32 part in (a metric engine)
BELOW_F32 = "bf16"


def round_values(values, precision: str):
    """numpy values rounded to bfloat16 where `precision` is "bf16" (as
    they are otherwise)."""
    import numpy as np

    if precision != "bf16":
        return values
    return _bf16(torch.as_tensor(np.asarray(values, np.float32))).double() \
        .numpy()
