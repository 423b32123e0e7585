"""secant_refine's share of its roofline in the traced frames: the sum of
each call's least time (benchmark/work.py) over the device time of every
operation launched inside those calls."""


def read(rec):
    dev = rec["entry_device_s"].get("secant_refine", 0.0)
    if dev <= 0:
        return None
    return 100.0 * rec["entry_bound_s"].get("secant_refine", 0.0) / dev
