"""Drivers by traffic kind: benchmark/kinds/<kind>.py holds class <Kind>."""
import sys
import time

_T0 = time.perf_counter()


def log(msg: str) -> None:
    """A set-up phase on standard error, with the seconds since import."""
    print(f"[{time.perf_counter() - _T0:8.2f} s] {msg}", file=sys.stderr,
          flush=True)
