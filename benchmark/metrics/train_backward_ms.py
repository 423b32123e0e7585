"""Mean device time between CUDA events recorded at the return of the
trainer's render_and_loss and at the entry of the optimizer's step, over
the traced steps: backward, the gradient norm."""


def read(rec):
    ms = rec.get("backward_ms") or []
    return sum(ms) / len(ms) if ms else None
