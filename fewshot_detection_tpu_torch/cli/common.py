"""Shared CLI plumbing: config resolution."""

from __future__ import annotations

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
