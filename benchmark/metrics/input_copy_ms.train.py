"""Device milliseconds a step of host-to-device copies in the profiled
stretch: the batch the trainer's `_to_device` copies from pageable memory."""


def read(rec):
    trace = rec.get("trace")
    if rec.get("kind") != "train" or trace is None or not trace.device:
        return None
    return 1e3 * trace.memcpy_s("HtoD") / trace.steps
