"""zamba2-7b [hybrid]: 81L d_model=3584, Mamba2 backbone + shared attention
blocks, ssm_state=64, d_ff=14336 (shared-block MLP), vocab=32000.
[arXiv:2411.15242]

Layout adaptation (DESIGN.md): 13 x (5 mamba + 1 shared-attn block) + 3 tail
mamba layers = 81; the 'shared' block reuses ONE attn+MLP param set at every
occurrence (per-occurrence KV cache), mirroring zamba2's shared blocks.
"""
from repro_torch.models.config import ArchConfig
from repro_torch.models.ssm import SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112,
    pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared"),
    tail=("mamba", "mamba", "mamba"),
    ssm=SSMConfig(d_model=3584, d_state=64, head_dim=64, expand=2, d_conv=4,
                  chunk=256),
    long_context=True,
)
