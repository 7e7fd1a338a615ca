"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global, 128k context. [hf:google/gemma-3; unverified]

The reference's long_500k: RUNS - 5/6 of layers are sliding-window(1024); the 8 global
layers' KV cache is sharded over the data axis (context parallelism).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144, head_dim=256,
    pattern=("local", "local", "local", "local", "local", "global"),
    window=1024, embed_scale=True, rope_theta=1_000_000.0,
    long_context=True,
)
