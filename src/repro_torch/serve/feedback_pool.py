"""Per-slot GVR feedback lifecycle over the decode-state pool.

`core.temporal` defines the feedback buffer and its array-level slot
operations; this module binds them to the serving pool: admission re-seeds
a slot (even-spacing prior over the new request's own prefix, validity
dropped), eviction poisons it (-1 indices). A generation counter per slot
lets tests and telemetry prove that no prediction ever crosses an
admit/evict boundary — the regression the paper's single-request framing
never had to state.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class FeedbackPool:
    """Slot lifecycle manager for the model's `prev_topk`/`topk_valid`
    decode state (the paper's L × B × K feedback buffer).

    The live arrays stay inside the decode state (torch tensors on the
    engine's device); this class applies the between-tick slot updates through the model's hooks and
    keeps host-side generation bookkeeping.
    """

    def __init__(self, model, num_slots: int):
        self.model = model
        self.num_slots = num_slots
        # generation[s] increments on every admission into slot s; -1 = never used
        self.generation = np.full((num_slots,), -1, np.int64)
        self.evictions = 0
        self.admissions = 0

    def admit(self, state: Dict, slot: int, *, seq_len_hint: int) -> Dict:
        """Reset slot for a fresh request: length 0, even-spacing seed over
        the request's own prefix [0, seq_len_hint), validity False — the
        first selection after admission takes the non-GVR path (row-level
        canUseHeuristic false), and flips to GVR once real feedback lands."""
        self.generation[slot] += 1
        self.admissions += 1
        return self.model.reset_slot_state(state, slot,
                                           seq_len_hint=seq_len_hint)

    def evict(self, state: Dict, slot: int) -> Dict:
        """Poison slot on retirement so the evicted request's indices can
        never be read as a prediction by the slot's next occupant."""
        self.evictions += 1
        return self.model.recycle_slot_state(state, slot)

    def valid_slots(self, state: Dict) -> List[bool]:
        """Host-side view: does slot s currently hold valid feedback
        (layer 0 — admission/eviction touch all layers together)?"""
        return [bool(v) for v in state["topk_valid"][0].tolist()]
