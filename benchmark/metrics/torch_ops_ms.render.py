"""Device time a frame of operations launched outside the program's kernel
entry points (ops.kernels): the sorts, gathers and context math in plain
torch."""


def read(rec):
    if rec["iters"] <= 0:
        return None
    return 1e3 * rec["outside_s"] / rec["iters"]
