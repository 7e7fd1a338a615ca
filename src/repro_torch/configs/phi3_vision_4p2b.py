"""phi-3-vision-4.2b [vlm]: 32L d_model=3072 32H d_ff=8192 vocab=32064;
phi3-mini backbone + CLIP vision tower.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The CLIP frontend is a stub: 1024 patch embeddings (``models/frontend.py``)
are prepended to the text sequence.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064, head_dim=96,
    pattern=("global",),
    frontend="vision", frontend_tokens=1024,
)
