"""hymba-1.5b [hybrid]: parallel attention+Mamba heads (arXiv:2411.13676).

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16. Sliding
window (2048) on the attention branch; the SSM branch carries global context,
making the arch sub-quadratic (runs long_500k).
"""
from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, d_ff=5504, vocab=32001, ssm_state=16,
    window=2048, rope_theta=10_000.0,
)
