"""Device milliseconds a step of the kernels the frozen kinds class as
elementwise, reduction or pooling: the batch-norm and activation
epilogues, the loss and the update."""


def read(rec):
    trace = rec.get("trace")
    if rec.get("kind") != "train" or trace is None or not trace.device:
        return None
    return 1e3 * trace.kernel_s("elementwise", "reduction", "pooling") / trace.steps
