"""granite-34b [dense]: llama-arch code model, MQA (kv=1).

88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152 [arXiv:2405.04324].
kv=1 replicates the KV projections on the 16-way model axis (divisibility
fallback, parallel/sharding.py); q-heads shard 48/16=3.
"""
from repro_torch.models.config import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense", n_layers=88, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152, head_dim=128,
    dsa=DSAConfig(enabled=True),
)

SMOKE = ModelConfig(
    name="granite-34b-smoke", family="dense", n_layers=3, d_model=128,
    n_heads=4, n_kv_heads=1, d_ff=256, vocab=512, head_dim=32,
    dsa=DSAConfig(enabled=True, k=16, indexer_heads=4, indexer_dim=16, min_n=8),
    dtype="float32",
)
