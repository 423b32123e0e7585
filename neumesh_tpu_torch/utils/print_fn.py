"""Coloured, rank-aware stdout logging (counterpart of
neumesh_tpu/utils/print_fn.py): the port's logger "neumesh_tpu_torch".
init_log (called by the training CLI) gives it a stdout handler that
drops the records of other ranks than 0 unless they set all_ranks;
without it, records go to whatever the caller configured."""
from __future__ import annotations

import logging
import os
import sys

_COLORS = {"WARNING": "\033[33m", "INFO": "\033[32m", "DEBUG": "\033[36m",
           "CRITICAL": "\033[35m", "ERROR": "\033[31m"}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelname)
        if color and sys.stdout.isatty():
            return f"{color}{msg}{_RESET}"
        return msg


def process_index() -> int:
    """The rank of this process (torch.distributed when initialised, else
    the RANK environment variable, else 0)."""
    try:
        import torch.distributed as tdist
        if tdist.is_available() and tdist.is_initialized():
            return tdist.get_rank()
    except ImportError:
        pass
    return int(os.environ.get("RANK", 0))


class _RankFilter(logging.Filter):
    def __init__(self, master_only: bool):
        super().__init__()
        self.master_only = master_only

    def filter(self, record):
        record.procidx = process_index()
        return (not self.master_only or getattr(record, "all_ranks", False)
                or record.procidx == 0)


log = logging.getLogger("neumesh_tpu_torch")


def init_log(level=logging.INFO, master_only: bool = True):
    if log.handlers:
        return log
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(_ColorFormatter(
        "%(asctime)s [proc %(procidx)s] %(levelname)s %(message)s",
        datefmt="%H:%M:%S"))
    handler.addFilter(_RankFilter(master_only))
    log.addHandler(handler)
    log.setLevel(level)
    log.propagate = False
    return log
