"""Inputs of kernel B1 (GVR Top-K) and B9's chained selection in the
regimes that set their time, made on the card from fixed seeds, for
`tools/phase_gvr_topk.py`, `tools/ab_decode_attn.py` and
`tools/sweep_gvr_cluster.py`.

K = 2048 and C = 6144 (llama3.2-1b's DSA). Scores are standard normal;
positions at or past a row's length hold the NEG sentinel, as the indexer
writes them. The regimes:

    kernel-mix   B=4, N=8192, lengths 8192/5000/1000/3001 (the kernel
                 phase of chip_smoke.py): warm, random, recycled (-1) and
                 evenly spaced predictions, one per slot
    warm         B=4, N=8192, full rows, predictions the Top-K of a copy
                 perturbed by 0.01
    random       B=4, N=8192, full rows, uniform random predictions
    recycled     B=4, N=8192, full rows, every prediction -1
    even         B=4, N=8192, full rows, K evenly spaced predictions
    plateau      B=1, N=8192, length 1000 < K, predictions -1: no
                 threshold passes between K and C, so every secant probe
                 runs and P4/P5 take the whole row
    warm-131072  B=4, N=131072, full rows, warm predictions

`chain_inputs` gives B9's chain at the kernel phase's verify tick: B=4,
Q=3 rows per slot at lengths L0+q+1 (L0 = 4999, 2299, 699, 7997), row
q+1 the row q perturbed by 0.01, row-0 predictions warm, random, -1 and
even.
"""

from __future__ import annotations

K, CMAX = 2048, 6144
NEG = -3.4028234663852886e38
REGIMES = ("kernel-mix", "warm", "random", "recycled", "even", "plateau",
           "warm-131072")
VERIFY_L0 = (4999, 2299, 699, 7997)


def _mask(x, lengths):
    import torch
    pos = torch.arange(x.shape[-1], device=x.device)
    ln = torch.tensor(lengths, device=x.device)
    return torch.where(pos < ln[..., None], x, torch.full_like(x, NEG))


def _warm(x, g):
    import torch
    noisy = x + 0.01 * torch.randn(x.shape, generator=g, device=x.device)
    return torch.topk(noisy, K, dim=-1).indices.sort(-1).values.int()


def regime_inputs(name: str, dev):
    """(scores (B, N) f32, prev (B, K) int32) of one regime."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1234 + REGIMES.index(name))
    b, n = (1, 8192) if name == "plateau" else (
        4, 131072 if name == "warm-131072" else 8192)
    x = torch.randn((b, n), generator=g, device=dev)
    if name == "kernel-mix":
        lengths = (8192, 5000, 1000, 3001)
        x = _mask(x, lengths)
        prev = torch.stack([
            _warm(x[:1], g)[0],
            torch.randint(0, n, (K,), generator=g, device=dev).int(),
            torch.full((K,), -1, dtype=torch.int32, device=dev),
            torch.linspace(0, lengths[3] - 1, K, device=dev).int()])
    elif name in ("warm", "warm-131072"):
        prev = _warm(x, g)
    elif name == "random":
        prev = torch.randint(0, n, (b, K), generator=g, device=dev).int()
    elif name == "even":
        prev = torch.linspace(0, n - 1, K, device=dev).int().expand(b, K)
    else:                                   # recycled, plateau
        if name == "plateau":
            x = _mask(x, (1000,))
        prev = torch.full((b, K), -1, dtype=torch.int32, device=dev)
    return x.contiguous(), prev.contiguous()


def chain_inputs(dev):
    """(scores (B, Q, N) f32, prev (B, K) int32) of B9's chain."""
    import torch
    g = torch.Generator(device=dev).manual_seed(4321)
    b, qn, n = 4, 3, 8192
    rows = [torch.randn((b, n), generator=g, device=dev)]
    for _ in range(qn - 1):
        rows.append(rows[-1] + 0.01 * torch.randn((b, n), generator=g, device=dev))
    x = torch.stack([_mask(r, [L + q + 1 for L in VERIFY_L0])
                     for q, r in enumerate(rows)], dim=1)
    prev = torch.stack([
        _warm(x[:1, 0], g)[0],
        torch.randint(0, n, (K,), generator=g, device=dev).int(),
        torch.full((K,), -1, dtype=torch.int32, device=dev),
        torch.linspace(0, VERIFY_L0[3] - 1, K, device=dev).int()])
    return x.contiguous(), prev.contiguous()
