"""Single-token GQA decode attention over a KV cache (flash-decoding)."""
