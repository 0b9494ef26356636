"""Flash-attention forward: tiled causal / sliding-window GQA attention."""
