"""Durable checkpoints of the port (`checkpointer.Checkpointer`), in the
JAX package's on-disk format."""
