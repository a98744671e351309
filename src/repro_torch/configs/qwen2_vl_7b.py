"""qwen2-vl-7b [vlm]: M-RoPE, dynamic-resolution ViT frontend (STUBBED).

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 [arXiv:2409.12191].
Per the assignment the vision frontend is a stub: input_specs() provides
precomputed patch embeddings for the first num_patches positions. 28 heads
do not divide the 16-way model axis -> attention weights replicate
(divisibility fallback); d_ff/vocab still shard.
"""
from repro_torch.models.config import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064, head_dim=128,
    rope_kind="mrope", num_patches=256, dsa=DSAConfig(enabled=True),
)

SMOKE = ModelConfig(
    name="qwen2-vl-7b-smoke", family="vlm", n_layers=2, d_model=96,
    n_heads=4, n_kv_heads=2, d_ff=192, vocab=512, head_dim=24,
    rope_kind="mrope", num_patches=8,
    dsa=DSAConfig(enabled=True, k=16, indexer_heads=4, indexer_dim=16, min_n=8),
    dtype="float32",
)
