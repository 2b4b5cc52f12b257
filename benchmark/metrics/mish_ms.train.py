"""Device milliseconds a step of the kernels whose lower-cased names hold
"mish" (PyTorch's Mish forward and backward after `bn_act`'s linear
epilogue; a later kernel that fuses Mish keeps the word in its name), over
the profiled stretch; nothing where the stretch has no such kernel."""


def read(rec):
    trace = rec.get("trace")
    if rec.get("kind") != "train" or trace is None or not trace.device:
        return None
    s = trace.seconds(lambda e: e["cat"] == "kernel" and "mish" in e["name"].lower())
    return 1e3 * s / trace.steps if s > 0 else None
