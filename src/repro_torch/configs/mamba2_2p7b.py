"""mamba2-2.7b [ssm]: 64L d_model=2560 attention-free, ssm_state=128 (SSD).
[arXiv:2405.21060]

Attention-free: the cache is the conv window and the SSD state, O(1) in
context length.  PDQ applies to the in/out projections; the SSD recurrence
stays in the model dtype and f32 (DESIGN.md Arch-applicability).
"""
from repro_torch.models.config import ArchConfig
from repro_torch.models.ssm import SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab=50280,
    pattern=("mamba",),
    ssm=SSMConfig(d_model=2560, d_state=128, head_dim=64, expand=2, d_conv=4,
                  chunk=256),
    long_context=True,
)
