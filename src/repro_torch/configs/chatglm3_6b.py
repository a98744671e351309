"""chatglm3-6b [dense]: GQA kv=2, 2d-RoPE (rotary on half the head dims).

28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024 [arXiv:2406.12793].
"""
from repro_torch.models.config import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense", n_layers=28, d_model=4096,
    n_heads=32, n_kv_heads=2, d_ff=13696, vocab=65024, head_dim=128,
    rope_fraction=0.5, dsa=DSAConfig(enabled=True),
)

SMOKE = ModelConfig(
    name="chatglm3-6b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
    rope_fraction=0.5,
    dsa=DSAConfig(enabled=True, k=16, indexer_heads=4, indexer_dim=16, min_n=8),
    dtype="float32",
)
