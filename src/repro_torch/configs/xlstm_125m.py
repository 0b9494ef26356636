"""xlstm-125m [ssm] (arXiv:2405.04517).

12L d_model=768 4H d_ff=0 vocab=50304 — alternating mLSTM/sLSTM blocks
(blocks carry their own projections; no separate FFN). Unrolled layers
(heterogeneous stack). Runs long_500k (O(1) recurrent state)."""
from ..models.lm import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304, scan_layers=False,
)
