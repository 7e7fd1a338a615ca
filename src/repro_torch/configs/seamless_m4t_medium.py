"""seamless-m4t-medium [audio]: enc-dec, 12L encoder + 12L decoder,
d_model=1024 16H d_ff=4096 vocab=256206. [arXiv:2308.11596; hf]

The speech frontend is a stub: precomputed frame embeddings
(``models/frontend.py``) feed the bidirectional encoder, whose output every
decoder layer cross-attends.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec", enc_layers=12,
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64,
    pattern=("global",),
    frontend="audio",
)
