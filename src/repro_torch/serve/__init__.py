"""Continuous-batching GVR decode engine (serving layer), PyTorch port.

The engine owns a fixed pool of B slots — the batch dimension of every
per-slot decode-state tensor. Requests flow QUEUED → PREFILL → DECODE →
DONE under a `Scheduler`; one tick runs one `serve_step_paged` over the
whole ragged pool, with finished, idle and prefilling slots masked out of
the state merge and their cache writes sent to the sink page. Freed slots
refill mid-stream through chunked prefill.

The paper's prev-Top-K feedback buffer (L × B × K int32) is the pool's
`prev_topk` state: admission re-seeds a slot's rows and drops
`topk_valid` (the first selection after admission is a cold row), eviction
poisons them with -1. `DecodeEngine.method_log` records which selector path
served each slot on each tick. With `spec_depth > 0` (paged layout) a
drafter from `serve.spec` proposes tokens and each decode tick verifies
them in one speculative verify tick.
"""

from .engine import DecodeEngine, EngineReport, Request
from .feedback_pool import FeedbackPool
from .paged import (AdmitPlan, BlockPool, BlockTable, PagedKVManager,
                    PoolExhausted, PrefixCache, ShardedPagedKVManager)
from .sampling import sample_token
from .spec import (Drafter, ModelDrafter, NgramDrafter, ReplayDrafter,
                   ScriptedDrafter)
from .scheduler import (DECODE, DONE, PREFILL, QUEUED, FIFOScheduler,
                        LongestContextFirstScheduler, Scheduler,
                        make_scheduler)

__all__ = [
    "DecodeEngine", "EngineReport", "Request", "FeedbackPool",
    "AdmitPlan", "BlockPool", "BlockTable", "PagedKVManager",
    "PoolExhausted", "PrefixCache", "ShardedPagedKVManager", "sample_token",
    "Scheduler", "FIFOScheduler", "LongestContextFirstScheduler",
    "make_scheduler", "QUEUED", "PREFILL", "DECODE", "DONE",
    "Drafter", "ModelDrafter", "NgramDrafter", "ReplayDrafter",
    "ScriptedDrafter",
]
