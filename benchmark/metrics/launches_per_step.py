"""Device kernels launched a training step, counted in the profiler's
trace."""


def read(rec):
    if rec["iters"] <= 0 or rec["launches"] <= 0:
        return None
    return rec["launches"] / rec["iters"]
