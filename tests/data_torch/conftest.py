"""Loaded while pytest collects tests/, before it imports
tests/test_native.py: it walks the directory in name order, and data_torch/
comes first.

tests/test_native.py asks the JAX package's native loader for its library
while it is collected, in every test process, and that loader compiles
straight into its output file when the file is missing. With several test
processes collecting a fresh tree at once, several compilers write one path
and a process can load the file while another is still writing it; the
loader then keeps the failure ("file too short") for the life of the
process, and test_native.py's tests are skipped there. So the library is
put in place whole here first, under the lock every test process takes
(`torch_port_util.build_jax_native_library`); when test_native.py is
collected it is there and fresh, and nothing compiles in place."""

from torch_port_util import build_jax_native_library

build_jax_native_library()
