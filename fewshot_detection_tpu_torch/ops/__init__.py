from .layers import (
    reorg,
    maxpool,
    maxpool_stride1,
    global_maxpool,
    global_avgpool,
    leaky_relu,
    batchnorm_apply,
    batchnorm_train,
)

__all__ = [
    "reorg",
    "maxpool",
    "maxpool_stride1",
    "global_maxpool",
    "global_avgpool",
    "leaky_relu",
    "batchnorm_apply",
    "batchnorm_train",
]
