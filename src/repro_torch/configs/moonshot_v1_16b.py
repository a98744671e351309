"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6.

48L d_model=2048 16H (GQA kv=16) d_ff=1408(expert) vocab=163840
[hf:moonshotai/Moonlight-16B-A3B]. In bf16 its weights take 57.8 GB
(`param_count()`: 28.9 B), most of one H100's 80 GB.
"""
from repro_torch.models.config import DSAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=0, vocab=163840, head_dim=128,
    moe=MoEConfig(num_experts=64, top_k=6, expert_d_ff=1408),
    dsa=DSAConfig(enabled=True),
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=512, head_dim=32,
    moe=MoEConfig(num_experts=8, top_k=3, expert_d_ff=64),
    dsa=DSAConfig(enabled=True, k=16, indexer_heads=4, indexer_dim=16, min_n=8),
    dtype="float32",
)
