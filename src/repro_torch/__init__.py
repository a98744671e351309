"""PyTorch/CUDA port of the GVR sparse-attention decoding system.

A second package beside the JAX reference (`repro`): same sub-layout
(`core/`, `sparse/`, `kernels/`, `models/`, `serve/`, `configs/`), PyTorch
inside, and a hand-written Hopper kernel in place of every TPU kernel on
its path (`kernels/`). It imports neither jax nor the JAX package. Entry
points (`models.api.build_model`, `serve.DecodeEngine`) run on the card
unless the caller passes device="cpu".
"""
