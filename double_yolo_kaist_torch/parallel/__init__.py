"""Data parallelism: a device mesh for inference in one process
(:mod:`.mesh`), one process a card for training (:mod:`.multihost`), and
the images' rows split over processes as well (:mod:`.spatial`, the 2-D
data x space mesh). Counterpart of the JAX package's ``parallel/``."""
