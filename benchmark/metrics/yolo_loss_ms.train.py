"""Device milliseconds a step of the kernels launched while the program's
`train.loss` span is the innermost one open (the YOLOv3 loss's forward:
targets, ignore mask, terms), from a profiled stretch with the program's
spans recorded; nothing where the run traced no kernel or the program
records no such span."""


def read(rec):
    if rec.get("kind") != "train" or rec.get("loss_device_s") is None:
        return None
    return 1e3 * rec["loss_device_s"] / rec["loss_steps"]
