"""Shared CLI plumbing: config resolution and replica layout."""

from __future__ import annotations

import os

from ..config import Settings, parse_cfg, read_data_cfg


def resolve_configs(datacfg: str, netcfg: str, learnetcfg: str | None = None):
    """argv -> (data_options, net_blocks, learnet_blocks, settings)."""
    data_options = read_data_cfg(datacfg)
    net_blocks = parse_cfg(netcfg)
    learnet_blocks = parse_cfg(learnetcfg) if learnetcfg else None
    settings = Settings.configure(
        data_options,
        net_blocks[0],
        learnet_blocks[0] if learnet_blocks else None,
    )
    return data_options, net_blocks, learnet_blocks, settings


def replica_layout(batch_size: int, n_groups: int | None = None, mesh=None):
    """(n_groups, per_group_batch). As the JAX package makes one replica
    group per device, a world of N ranks (`mesh`) makes N groups, one a
    rank; one process makes one. `n_groups` may ask for more, a multiple of
    N: each rank then runs its share one after another. The group count
    must divide the batch, else this raises: the JAX package's fallback to
    one group on one device has no meaning for N processes."""
    world = mesh.size if mesh is not None else 1
    r = n_groups or world
    if r % world:
        raise ValueError(f"{r} replica groups do not split over {world} ranks")
    if batch_size % r:
        raise ValueError(f"{r} replica groups do not divide the batch of {batch_size}")
    return r, batch_size // r


def ensure_backup_dir(settings) -> str:
    backupdir = settings.backup
    os.makedirs(backupdir, exist_ok=True)
    return backupdir
