"""chameleon-34b [vlm] early-fusion (arXiv:2405.09818).

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. The VQ image
tokenizer is a STUB: the model takes fused text+image token ids over the
shared 65536 vocab; the backbone is a dense decoder with qk-norm
(chameleon's training stabilizer)."""
from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm", n_layers=48, d_model=8192,
    n_heads=64, n_kv_heads=8, d_ff=22016, vocab=65536, qk_norm=True,
)
