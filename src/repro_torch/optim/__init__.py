"""AdamW with clipping and a warmup-cosine schedule (``adamw``), and int8
gradient compression with error feedback (``compression``)."""
