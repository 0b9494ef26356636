"""Step-atomic, async checkpoints in the JAX package's layout
(``checkpointer``)."""
