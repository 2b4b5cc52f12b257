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


def replica_layout(batch_size: int, n_groups: int | None = None):
    """(n_groups, per_group_batch). The JAX package makes one replica group
    per device; the port drives one device, so there is one group unless the
    caller asks for more (they then run one after another on that device).
    A group count that does not divide the batch falls back to one group."""
    r = n_groups or 1
    if r > 1 and batch_size % r == 0:
        return r, batch_size // r
    return 1, batch_size


def ensure_backup_dir(settings) -> str:
    backupdir = settings.backup
    os.makedirs(backupdir, exist_ok=True)
    return backupdir
