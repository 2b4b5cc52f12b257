"""The `bn_sums` kernels' share of their roofline: the least bytes of the
BN statistics of a step (each BN layer's (M, C) from the spec: the forward
reads x and writes the sums, the backward reads x and writes dx) at the
HBM rate, over the device time a step of the `bn_sums_*` kernels."""


def read(rec):
    trace = rec.get("trace")
    if rec.get("kind") != "train" or trace is None or not rec.get("peaks"):
        return None
    busy = trace.kernel_s("bn_sums") / trace.steps
    if busy <= 0:
        return None
    return 100.0 * rec["bn_bytes_per_step"] / rec["peaks"]["hbm_bytes"] / busy
