"""The reference's elementwise pieces: norm, rotary embedding, matmul and
the float8 rounding of the control."""

from __future__ import annotations

import torch

FP8_MAX = 448.0          # largest finite float8 e4m3 value


def full_precision() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along `dim` (its
    largest magnitude maps to 448), back in float32."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def rnd(x: torch.Tensor, low, dim: int = -1) -> torch.Tensor:
    """x in float32 rounded to the precision `low`: None (none), "fp8"
    (float8 e4m3, scaled per slice along `dim`) or "bf16" (bfloat16, the
    witness that computes as the served model stores)."""
    x = x.float()
    if low == "fp8":
        return fp8(x, dim)
    if low == "bf16":
        return x.to(torch.bfloat16).float()
    if low is not None:
        raise ValueError(f"unknown precision {low!r}")
    return x


def mm(x: torch.Tensor, w: torch.Tensor, low=None) -> torch.Tensor:
    """x (..., in) @ w (in, out) in float32; under `low` both rounded
    first (x per row, w per output column), and under "bf16" the product
    too, as a bfloat16 matmul stores it."""
    out = rnd(x, low, -1) @ rnd(w, low, 0)
    return rnd(out, low) if low == "bf16" else out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, *, base: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding of x (T, heads, dim) at positions (T,): the pairs
    (2i, 2i+1) of the first `fraction` of the dims turn by position x
    base^(-2i / rotated dims); the rest pass through."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    freqs = 1.0 / (torch.tensor(float(base), device=x.device)
                   ** (torch.arange(0, rot, 2, device=x.device).float() / rot))
    ang = positions.float()[:, None] * freqs[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.reshape(x[..., :rot].shape), x[..., rot:]], dim=-1)
