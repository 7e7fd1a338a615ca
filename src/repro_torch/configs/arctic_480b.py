"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual. [hf:Snowflake/snowflake-arctic-base; hf]

The reference's long_500k: SKIPPED - pure full attention.
"""
from repro_torch.models.config import ArchConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128,
    pattern=("global",),
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True, d_ff_dense=4864),
)
