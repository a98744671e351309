"""Non-greedy sampling for the decode engine: temperature + top-p (nucleus).

Greedy (temperature == 0) remains the engine default and bypasses this
module. A sampling request carries its own `torch.Generator` (on the CPU),
seeded per request (`seed`, falling back to the request uid) and re-created
on every (re-)admission, so a trace replays deterministically even across
preemption. The draws are torch's, not the JAX package's threefry draws:
the two agree in distribution, not draw for draw.
"""

from __future__ import annotations

import torch


def request_key(seed: int) -> torch.Generator:
    """Per-request generator (re-created at every admission)."""
    return torch.Generator(device="cpu").manual_seed(int(seed))


def sample_token(logits, generator: torch.Generator, *, temperature: float,
                 top_p: float = 1.0) -> int:
    """Draw one token id from `logits` (V,) with temperature + nucleus.

    top_p keeps the minimal probability-sorted prefix whose cumulative mass
    reaches `top_p` (always at least one token); the categorical draw then
    happens over the renormalized nucleus.
    """
    logits = torch.as_tensor(logits).detach().float().cpu()
    if temperature <= 0.0:
        return int(torch.argmax(logits))
    logits = logits / temperature
    if top_p < 1.0:
        probs = torch.softmax(logits, dim=-1)
        order = torch.argsort(-probs)
        sp = probs[order]
        # exclusive cumulative mass: a token survives while the mass of all
        # strictly more probable tokens is < top_p
        keep_sorted = (torch.cumsum(sp, 0) - sp) < top_p
        keep = torch.zeros_like(keep_sorted)
        keep[order] = keep_sorted
        logits = torch.where(keep, logits, torch.full_like(logits, -torch.inf))
    probs = torch.softmax(logits, dim=-1)
    return int(torch.multinomial(probs, 1, generator=generator))
