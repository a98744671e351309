"""Speculative decoding over the paged GVR serving stack (draft, verify,
roll back), PyTorch port.

* Drafters (`spec.drafter`) propose up to `spec_depth` next tokens per
  DECODE slot from host-side state: `NgramDrafter` self-drafts by suffix
  lookup over the slot's own tokens, `ModelDrafter` runs a draft model on
  the port's dense decode step, `ReplayDrafter` / `ScriptedDrafter` are the
  measurement and test forms (oracle replay: every draft accepted; scripts:
  any accept/reject trace).
* The verify tick (`models.transformer.serve_step_spec_paged`) scores all
  d+1 positions of each slot, with the GVR feedback extended inside the
  tick (position j's Top-K warm-starts position j+1): as d+1 paged steps
  (`verify_kernel="scan"`) or as one multi-query forward
  (`verify_kernel="mq"`, kernels B9 and B8 in the fused form).
* Rollback is exact: acceptance rolls `length` and the feedback leaves back
  to the accepted position on the device, and the engine rewinds the block
  table and ref-counts on the host (`PagedAdmissionCore.rewind_slot`), so
  greedy speculative decoding emits the non-speculative tokens for every
  accept/reject trace.

Speculation applies to greedy requests only: sampled requests verify with
draft length 0, i.e. the ordinary one-token step.
"""

from .drafter import (Drafter, ModelDrafter, NgramDrafter, ReplayDrafter,
                      ScriptedDrafter)

__all__ = ["Drafter", "ModelDrafter", "NgramDrafter", "ReplayDrafter",
           "ScriptedDrafter"]
