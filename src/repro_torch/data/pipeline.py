"""Deterministic sharded synthetic data pipeline, the JAX package's
`data/pipeline.py` with numpy alone: the same arrays for every (step,
host_id, num_hosts), `frames` (audio) and `patch_embeds` (vlm) included.

Production-shaped: per-host deterministic sharding (host h of H reads
disjoint index ranges), background prefetch, and step-indexed seeding so a
restart at step s regenerates exactly the batches a failed run would have
consumed (checkpoint/restart determinism).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


def batch_for_step(step: int, *, vocab: int, batch: int, seq: int,
                   seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                   family: str = "dense", cfg=None) -> Dict[str, np.ndarray]:
    """Pure function (step -> batch): the unit of determinism/elasticity.

    Re-sharding after a host failure only changes (host_id, num_hosts); the
    global stream stays identical because draws are indexed by global row id.
    """
    assert batch % num_hosts == 0
    local = batch // num_hosts
    rows = np.arange(local) + host_id * local
    out_tokens = np.empty((local, seq + 1), np.int32)
    for i, r in enumerate(rows):
        rng = np.random.default_rng(
            np.random.SeedSequence([seed, step, int(r)]))
        out_tokens[i] = rng.integers(0, vocab, seq + 1, dtype=np.int32)
    b = {"tokens": out_tokens[:, :-1], "targets": out_tokens[:, 1:]}
    if cfg is not None and getattr(cfg, "family", "") == "audio":
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, 7]))
        b["frames"] = rng.standard_normal(
            (local, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg is not None and getattr(cfg, "num_patches", 0):
        rng = np.random.default_rng(np.random.SeedSequence([seed, step, 11]))
        b["patch_embeds"] = rng.standard_normal(
            (local, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return b


def synthetic_stream(*, vocab: int, batch: int, seq: int, seed: int = 0,
                     host_id: int = 0, num_hosts: int = 1,
                     prefetch: int = 2, family: str = "dense",
                     cfg=None) -> Iterator[Dict[str, np.ndarray]]:
    """Background-prefetched iterator over batch_for_step."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = seed
        while not stop.is_set():
            b = batch_for_step(step, vocab=vocab, batch=batch, seq=seq,
                               host_id=host_id, num_hosts=num_hosts,
                               family=family, cfg=cfg)
            q.put(b)
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
