"""granite-moe-1b-a400m [moe]: 32 experts top-8.

24L d_model=1024 16H (GQA kv=8) d_ff=512(expert) vocab=49155
[hf:ibm-granite/granite-3.0-1b-a400m-base].
"""
from repro_torch.models.config import DSAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=0, vocab=49155, head_dim=64,
    moe=MoEConfig(num_experts=32, top_k=8, expert_d_ff=512),
    dsa=DSAConfig(enabled=True),
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=0, vocab=515, head_dim=32,
    moe=MoEConfig(num_experts=8, top_k=4, expert_d_ff=64),
    dsa=DSAConfig(enabled=True, k=16, indexer_heads=4, indexer_dim=16, min_n=8),
    dtype="float32",
)
