"""Share of the profiled training stretch with no kernel, copy or memset
on the card: one minus the union of device intervals over the window."""


def read(rec):
    trace = rec.get("trace")
    if rec.get("kind") != "train" or trace is None:
        return None
    return trace.idle_pct()
