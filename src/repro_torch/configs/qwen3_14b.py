"""qwen3-14b [dense] (hf:Qwen/Qwen3 family).

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936, qk-norm,
head_dim=128, rope theta 1M."""
from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=17408, vocab=151936,
    qk_norm=True, head_dim=128, rope_theta=1_000_000.0,
)
