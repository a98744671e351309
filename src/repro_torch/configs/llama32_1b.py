"""llama3.2-1b [dense]: small llama3.

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B]. head_dim=64, rope base 500000 (llama3).
"""
from repro_torch.models.config import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense", n_layers=16, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=128256, head_dim=64,
    rope_base=500000.0, tie_embeddings=True, dsa=DSAConfig(enabled=True),
)

SMOKE = ModelConfig(
    name="llama3.2-1b-smoke", family="dense", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
    rope_base=500000.0, tie_embeddings=True,
    dsa=DSAConfig(enabled=True, k=16, indexer_heads=4, indexer_dim=16, min_n=8),
    dtype="float32",
)
