"""The train step: loss, gradients, compression and AdamW (``step``)."""
