"""The whole training step's share of the card's dense bfloat16 peak: the
spec's FLOPs of a step (forward and both gradients, recomputed operations
not counted) times the steps of the untraced window, over its seconds."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("peaks"):
        return None
    rate = rec["step_flops"] * rec["steps"] / rec["untraced_s"]
    return 100.0 * rate / rec["peaks"]["bf16_flops"]
