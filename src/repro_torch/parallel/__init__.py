"""Parallelism helpers. Only :func:`~repro_torch.parallel.sharding.padded_vocab`
so far; the mesh and ``Sharder`` wait for multi-GPU (ROADMAP item 14)."""
