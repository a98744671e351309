"""RoPE / YaRN positional-score structure (paper §3.2–3.3, Appendix E),
PyTorch port of the JAX package's `core/rope.py`.

The DSA indexer scores carry a Toeplitz positional component

    g(Delta) = 2 * sum_i cos(Delta * theta_i),   theta_i = beta^(-2i/d_rope)

(paper Eq. 2). Because g depends only on the relative position Delta, the
positional score matrix is Toeplitz, and advancing the query by one step
only perturbs the landscape smoothly — the structural basis for the
temporal correlation GVR exploits. YaRN interpolation (scaling factor 40
in DeepSeek-V3.2) preserves peaks at large Delta, spreading the Top-K
prior over both near and remote positions.

The frequencies are computed in numpy, as the reference computes them, so
both packages start from the same float32 values. `generate_indexer_scores`
draws its random Q/K from an explicit `torch.Generator` on the
generator's device; `scores_from_qk` is the deterministic rest, which
takes the draws as arguments.
"""

from __future__ import annotations

import math

import numpy as np
import torch

D_ROPE = 64          # indexer RoPE dimensions in DeepSeek-V3.2
ROPE_BASE = 10000.0
YARN_SCALING = 40.0  # DeepSeek-V3.2 YaRN scaling factor


def yarn_inv_freq(dim: int = D_ROPE, base: float = ROPE_BASE,
                  sf: float = YARN_SCALING, orig_max: int = 4096,
                  bf: float = 32.0, bs: float = 1.0, device=None) -> torch.Tensor:
    """DeepSeek-V3.2 YaRN frequency computation (paper Appendix E)."""
    pos_f = base ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    freq_extra = 1.0 / pos_f
    freq_inter = 1.0 / (sf * pos_f)
    lo = max(int(dim * math.log(orig_max / (bf * 2 * math.pi)) / (2 * math.log(base))), 0)
    hi = min(int(math.ceil(dim * math.log(orig_max / (bs * 2 * math.pi))
                           / (2 * math.log(base)))), dim - 1)
    ramp = np.clip((np.arange(dim // 2, dtype=np.float32) - lo) / max(hi - lo, 1e-3),
                   0.0, 1.0)
    freq = freq_inter * ramp + freq_extra * (1.0 - ramp)
    return torch.as_tensor(freq.astype(np.float32), device=device)


def rope_inv_freq(dim: int = D_ROPE, base: float = ROPE_BASE,
                  device=None) -> torch.Tensor:
    """Plain (non-YaRN) RoPE inverse frequencies."""
    pos_f = base ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    return torch.as_tensor((1.0 / pos_f).astype(np.float32), device=device)


def g_delta(n: int, dim: int = D_ROPE, *, yarn: bool = True,
            device=None) -> torch.Tensor:
    """Positional score g(Delta) for Delta in [0, n) (paper Eq. 2): the
    inner product of all-ones vectors rotated by R_Delta. (n,) float32."""
    theta = (yarn_inv_freq(dim, device=device) if yarn
             else rope_inv_freq(dim, device=device))
    delta = torch.arange(n, dtype=torch.float32, device=device)
    return 2.0 * torch.cos(delta[:, None] * theta[None, :]).sum(dim=1)


def compute_static_pre_idx(n: int, k: int = 2048, d_rope: int = D_ROPE,
                           device=None) -> torch.Tensor:
    """preIdx from the all-ones RoPE structural prior (paper Eq. 3 /
    App. E): the K relative positions with the largest g(Delta), largest
    first, equal values lowest index first (`lax.top_k`'s order). (K,)
    int32."""
    f = g_delta(n, d_rope, device=device)
    order = torch.sort(f, descending=True, stable=True).indices
    return order[:min(k, n)].to(torch.int32)


def apply_rope(x: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor) -> torch.Tensor:
    """Rotate pairs in the paper's listing layout (split-halves concat)."""
    x1, x2 = x[..., ::2], x[..., 1::2]
    return torch.cat([x1 * cos_t - x2 * sin_t, x2 * cos_t + x1 * sin_t], dim=-1)


def scores_from_qk(q: torch.Tensor, kmat: torch.Tensor,
                   d_rope: int = D_ROPE) -> torch.Tensor:
    """Indexer scores of one query at position 0 against keys at positions
    0..n-1, both YaRN-RoPE'd: q (1, d_rope), kmat (n, d_rope) float32.
    Returns (n,) float32."""
    n = kmat.shape[0]
    inv_freq = yarn_inv_freq(d_rope, device=kmat.device)
    pos = torch.arange(n, dtype=torch.float32, device=kmat.device)
    ang = pos[:, None] * inv_freq[None, :]
    cos_t, sin_t = torch.cos(ang), torch.sin(ang)
    qr = apply_rope(q, cos_t[:1], sin_t[:1])
    return (qr @ apply_rope(kmat, cos_t, sin_t).T).squeeze(0)


def generate_indexer_scores(generator: torch.Generator, n: int, k: int = 2048,
                            am: float = 0.1, d_rope: int = D_ROPE):
    """Synthetic indexer scores (random Q/K + YaRN-RoPE) and the static
    preIdx, on the generator's device (the paper's Appendix E
    `generate_indexer_scores`): q = 1 + am·N(0, 1) of shape (1, d_rope),
    keys 1 + am·N(0, 1) of shape (n, d_rope), the query at position 0, so
    Delta is the key position and the static prior indexes positions
    directly. Returns (scores (n,) f32, pre_idx (min(k, n),) int32)."""
    dev = generator.device
    q = 1.0 + am * torch.randn((1, d_rope), generator=generator, device=dev)
    kmat = 1.0 + am * torch.randn((n, d_rope), generator=generator, device=dev)
    return scores_from_qk(q, kmat, d_rope), compute_static_pre_idx(n, k, d_rope, dev)
