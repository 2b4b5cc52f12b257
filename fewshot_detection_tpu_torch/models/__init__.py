from .spec import NetSpec, LayerSpec, RegionSpec, build_spec
from .darknet import init_params, apply_network, fold_batchnorm
from .convert import from_jax_params, to_jax_params
from . import weights_io

__all__ = [
    "NetSpec",
    "LayerSpec",
    "RegionSpec",
    "build_spec",
    "init_params",
    "apply_network",
    "fold_batchnorm",
    "from_jax_params",
    "to_jax_params",
    "weights_io",
]
