"""fewshot_detection_tpu_torch — the PyTorch/CUDA port of fewshot_detection_tpu.

Same sub-packages and module names as the JAX package, so each module's
counterpart is found by name. Plain tensor code is PyTorch; the greedy-NMS
kernel of the serving path (`csrc/nms.cu`) and the BatchNorm-statistics
kernels of the training path, forward and backward (`csrc/bn_sums.cu`), are
CUDA C++ for Hopper, built at first use. Nothing here imports JAX or the JAX
package.

Public functions keep the JAX package's layout at their boundary: NHWC
images, `(N, 1, 1, C)` class codes, image-major `B*n_cls` rows, and HWIO
weights in the numpy parameter tree that the `.weights` codec reads and
writes. Entry points take an explicit `device` and default to `"cuda"`.
"""

__version__ = "0.1.0"
