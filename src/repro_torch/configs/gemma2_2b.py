"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000,
local+global alternating, logit softcap. [arXiv:2408.00118; hf]

The reference's long_500k: RUNS - half the layers are sliding-window(4096); global layers'
KV sharded over the data axis.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4,
    d_ff=9216, vocab=256000, head_dim=256,
    pattern=("local", "global"), window=4096,
    attn_softcap=50.0, logit_softcap=30.0, embed_scale=True,
    long_context=True,
)
