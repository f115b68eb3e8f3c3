"""Data parallelism: a device mesh for inference in one process
(:mod:`.mesh`) and one process a card for training (:mod:`.multihost`).
Counterpart of the JAX package's ``parallel/``."""
