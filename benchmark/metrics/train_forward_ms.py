"""Mean device time between CUDA events recorded at the entry and the
return of the trainer's render_and_loss, over the traced steps."""


def read(rec):
    ms = rec.get("forward_ms") or []
    return sum(ms) / len(ms) if ms else None
