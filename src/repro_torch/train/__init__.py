"""The train step: loss, gradients, compression and AdamW (``step``); the
GPipe pipeline over a ``stage`` mesh axis (``pipeline``)."""
