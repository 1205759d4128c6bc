"""Parallelism: the port's door to ``torch.distributed``
(:mod:`~repro_torch.parallel.collectives`) and the sharding rules
(:mod:`~repro_torch.parallel.sharding`)."""
