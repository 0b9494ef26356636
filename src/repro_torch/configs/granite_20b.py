"""granite-20b [dense] code model (arXiv:2405.04324).

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152. gpt-bigcode style:
non-gated GELU MLP."""
from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense", n_layers=52, d_model=6144,
    n_heads=48, n_kv_heads=1, d_ff=24576, vocab=49152, gated_mlp=False,
)
