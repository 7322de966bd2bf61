"""Tensor-parallel layout of the serving engine (``sharding``)."""
