"""whisper-small [audio] enc-dec (arXiv:2212.04356).

12L encoder + 12L decoder, d_model=768 12H (kv=12) d_ff=3072 vocab=51865.
The conv audio frontend is a STUB: the encoder takes precomputed frame
embeddings [B, 1500, 768]."""
from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", n_layers=12, d_model=768,
    n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865,
    enc_layers=12, enc_seq=1500, gated_mlp=False, scan_layers=False,
)
