"""Kinds of device operation by name (frozen copies).

`KINDS` and `kind_of` are `scripts/torch_train_profile.py`'s; the first
pattern that a lower-cased name holds decides, so the port's `bn_sums_*`
kernels are told apart before the generic patterns. `kernel_base_name` is
`utils/trace_summary.py`'s."""

from __future__ import annotations

KINDS = (
    ("bn_sums", ("bn_sums_",)),
    ("convolution", ("conv", "cudnn", "xmma", "implicit_gemm", "wgrad", "dgrad", "fprop", "cutlass",
                     "fft", "winograd")),
    ("matrix product", ("gemm", "cublas", "gemv")),
    ("pooling", ("pool",)),
    ("reduction", ("reduce",)),
    ("copies and casts", ("copy", "memcpy", "memset", "cat", "fill")),
    ("elementwise", ("elementwise", "vectorized", "where", "index", "scatter", "gather", "sort")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, pats in KINDS:
        if any(p in low for p in pats):
            return kind
    return "other"


def kernel_base_name(name: str) -> str:
    """`void ns::(anonymous namespace)::kern<4, float>(float*, int)` ->
    `ns::kern`; a name that would come out empty stays whole."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[len("void "):]
    for stop in ("<", "("):
        if base.find(stop) > 0:
            base = base[:base.index(stop)]
    return base.strip() or name
