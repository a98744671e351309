"""jamba-1.5-large-398b [hybrid]: Mamba+attention 1:7 interleave, MoE 16e top-2.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536 [arXiv:2403.19887].
9 superblocks x (1 attn + 7 mamba); MoE on odd layers / dense FFN on even,
reproducing the 398B-total / ~94B-active split. The paper-representative
long-context arch: long_500k decode runs SP-DSA (sequence-parallel GVR) on
the attention layers while Mamba carries O(1) state.
"""
from repro_torch.models.config import DSAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid", n_layers=72, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536, head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=2, expert_d_ff=24576),
    attn_every=8, dsa=DSAConfig(enabled=True),
)

SMOKE = ModelConfig(
    name="jamba-smoke", family="hybrid", n_layers=8, d_model=128,
    n_heads=4, n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
    moe=MoEConfig(num_experts=4, top_k=2, expert_d_ff=64),
    attn_every=8,
    dsa=DSAConfig(enabled=True, k=16, indexer_heads=4, indexer_dim=16, min_n=8),
    dtype="float32",
)
