"""Synthetic in situ simulations (CloverLeaf-, NekRS-, S3D-like).

The port of ``repro.insitu.simulation``. Each simulation owns a rectangular
domain decomposition; ``step()`` advances time and ``publish`` generates
every rank's local partition *with ghost cells included* (the paper's
assumption: ghosts are precomputed by the simulation, so DVNR training
needs no halo exchange) on the simulation's device. Fields are the analytic
time-dependent generators of :mod:`repro_torch.data.volume`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.backends import resolve_device
from repro_torch.data.volume import VolumePartition, make_partition, partition_grid


@dataclass
class SimulationConfig:
    kind: str                              # cloverleaf | nekrs | s3d
    n_ranks: int = 4
    local_shape: Tuple[int, int, int] = (32, 32, 32)
    dt: float = 0.02
    fields: Tuple[str, ...] = ()           # extra fields beyond the primary
    ghost: int = 1


_PRIMARY_FIELD = {"cloverleaf": "cloverleaf", "nekrs": "nekrs", "s3d": "s3d"}


class SyntheticSimulation:
    """A data-distributed solver stand-in with Ascent-style publish().
    ``device``: where the partitions are made (``"auto"``: the GPU)."""

    def __init__(self, cfg: SimulationConfig, *, device="auto"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.grid = partition_grid(cfg.n_ranks)
        self.t = 0.0
        self.cycle = 0
        self._published: Dict[str, List[VolumePartition]] = {}

    @property
    def field_names(self) -> Tuple[str, ...]:
        return (_PRIMARY_FIELD[self.cfg.kind],) + tuple(self.cfg.fields)

    def step(self) -> None:
        self.t += self.cfg.dt
        self.cycle += 1
        self._published.clear()

    def publish(self, field: str) -> List[VolumePartition]:
        """Zero-copy-style handle: partitions are generated once per cycle and
        memoized (the simulation 'owns' them until the next step)."""
        if field not in self._published:
            self._published[field] = [
                make_partition(field, r, self.grid, self.cfg.local_shape,
                               t=self.t, ghost=self.cfg.ghost,
                               device=self.device)
                for r in range(self.cfg.n_ranks)
            ]
        return self._published[field]

    def global_shape(self) -> Tuple[int, int, int]:
        px, py, pz = self.grid
        nx, ny, nz = self.cfg.local_shape
        return (px * nx, py * ny, pz * nz)

    def raw_bytes_per_step(self, field: str = "") -> int:
        """Uncompressed size of one field over all ranks (Fig. 12 red line)."""
        return int(np.prod(self.global_shape())) * 4
