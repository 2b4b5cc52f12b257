from .darkcfg import parse_cfg, read_data_cfg, propagate_shapes, format_net_table
from .settings import Settings

__all__ = [
    "parse_cfg",
    "read_data_cfg",
    "propagate_shapes",
    "format_net_table",
    "Settings",
]
