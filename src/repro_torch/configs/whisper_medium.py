"""whisper-medium [audio]: enc-dec, conv frontend STUBBED per assignment.

24L d_model=1024 16H (kv=16) d_ff=4096 vocab=51865 [arXiv:2212.04356].
Encoder consumes precomputed frame embeddings (1500 frames). Decoder
self-attention is DSA-eligible; cross-attention over 1500 frames stays
exact (below any Top-K gate). vocab 51865 replicates (divisibility).
"""
from repro_torch.models.config import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, d_ff=4096, vocab=51865, head_dim=64,
    encoder_layers=24, encoder_frames=1500, dsa=DSAConfig(enabled=True),
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=256, vocab=512, head_dim=32,
    encoder_layers=2, encoder_frames=64,
    dsa=DSAConfig(enabled=True, k=16, indexer_heads=4, indexer_dim=16, min_n=8),
    dtype="float32",
)
