"""The traced training steps' model FLOPs (benchmark/work.py) over their
wall time, as a share of the card's dense bf16 peak."""


def read(rec):
    if rec["window_s"] <= 0 or rec["model_flops"] <= 0:
        return None
    return 100.0 * rec["model_flops"] / rec["window_s"] / rec["peak_flops"]
