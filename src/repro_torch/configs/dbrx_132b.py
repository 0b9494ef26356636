"""dbrx-132b [moe] (hf:databricks/dbrx-base).

40L d_model=6144 48H (GQA kv=8) per-expert d_ff=10752 vocab=100352,
MoE 16 experts top-4."""
from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=8, d_ff=10752, vocab=100352,
    n_experts=16, moe_top_k=4,
)
