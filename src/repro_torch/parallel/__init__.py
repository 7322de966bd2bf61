"""Layouts and collectives across ranks: the serving engine's tensor
parallelism and the trainer's data axis (``sharding``), the training
collectives and JAX's compressed and hierarchical ones (``collectives``),
and the GPipe pipeline (``pipeline``)."""
