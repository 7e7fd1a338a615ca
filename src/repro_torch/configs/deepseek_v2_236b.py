"""deepseek-v2-236b [moe]: 60L d_model=5120 128H MLA d_ff_expert=1536
vocab=102400, MoE 160e top-6, 2 shared experts; MLA kv_lora=512.
[arXiv:2405.04434; hf]

Layer 0 is a dense FFN (as in the released model); remaining 59 layers MoE.
The reference's long_500k: SKIPPED - full (MLA) attention.
"""
from repro_torch.models.config import ArchConfig, MLAConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-236b",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=12288, vocab=102400,
    head=("global_dense",), pattern=("global",),
    mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                  d_ff_dense=12288, router_scale=16.0),
    rope_theta=10_000.0,
)
