"""The convolutions' and the fused head product's share of their roofline:
the spec's FLOPs of a step at the dense bfloat16 peak, over the device
time a step of the kernels classed as convolution or matrix product."""


def read(rec):
    trace = rec.get("trace")
    if rec.get("kind") != "train" or trace is None or not rec.get("peaks"):
        return None
    busy = trace.kernel_s("convolution", "matrix product") / trace.steps
    if busy <= 0:
        return None
    return 100.0 * rec["step_flops"] / rec["peaks"]["bf16_flops"] / busy
