"""moonshot-v1-16b-a3b [moe] (hf:moonshotai/Moonlight-16B-A3B).

48L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=163840,
MoE 64 experts top-6 (fine-grained, ~3B active)."""
from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840,
    n_experts=64, moe_top_k=6,
)
