"""The benchmark's plain reference of the detector's training step: plain
PyTorch, written from the published description (Kang et al., ICCV 2019,
and the authors' PyTorch code; YOLOv2 for the plain head). It imports
nothing of the program and takes nothing the program made: the benchmark
hands it the weights, images and targets it made itself.

It computes in the type the configuration states (`darknet.py`).
`precision` names how the operands of every convolution's three products
(forward, input gradient, weight gradient) and every activation are
rounded on top of that: "fp32" (none), "tf32" (10 mantissa bits), "fp8"
(e4m3 values and e5m2 gradients, one scale a tensor) or "int8"
(symmetric, one scale a tensor).
The controls of the correctness check run the reference at a precision
below the one the configuration states."""
