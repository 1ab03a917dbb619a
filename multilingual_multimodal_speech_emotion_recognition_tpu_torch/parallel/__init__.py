"""Parallelism of the port: the mesh and its sharding rules, one process
per card, ring attention over a sharded frame axis and the GPipe encoder
pipeline."""
