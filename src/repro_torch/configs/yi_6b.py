"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000,
llama-arch GQA. [arXiv:2403.04652; hf]

The reference's long_500k: SKIPPED - pure full attention.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128,
    pattern=("global",),
)
