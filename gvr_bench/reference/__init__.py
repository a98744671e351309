"""The plain reference the benchmark holds the port's output against.

Plain PyTorch in float32 (TF32 off), written from the equations the
configuration files state (`model` block), with no kernels, no pages and no
batching. It imports neither JAX, nor the JAX package, nor anything of the
port, and takes nothing the port has made: it draws the restored rows again
from the seed and recomputes every query, score, Top-K and cache row.
`low="fp8"` computes the same in float8 (e4m3, scaled per row), the
precision below the configurations' bfloat16: the control that the
comparison must fail.
"""
