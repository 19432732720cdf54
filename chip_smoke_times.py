#!/usr/bin/env python3
"""``chip_smoke.py`` with each of its top-level functions timed.

    python3 chip_smoke_times.py [chip_smoke.py's arguments]

Runs the smoke's ``main`` unchanged and prints ``probe-time <function>
<seconds>`` for every call of one of its functions that takes more than a
second (nested calls print too; ``run_ranks`` and ``_world_ranks`` add the
tail of the command they started). It shows where the smoke's wall time
goes inside each phase of its ``phases`` line. It needs what the smoke
needs: one CUDA device.
"""

import functools
import inspect
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke  # noqa: E402


def timed(name, fn):
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            if dt > 1.0:
                what = ""
                if name in ("run_ranks", "_world_ranks") and args:
                    what = " " + repr(args[0][-6:])[:160]
                print(f"probe-time {name} {dt:.1f}{what}", flush=True)
    return inner


def main(argv=None) -> int:
    for name, fn in list(vars(chip_smoke).items()):
        if (inspect.isfunction(fn) and fn.__module__ == chip_smoke.__name__
                and name != "main"):
            setattr(chip_smoke, name, timed(name, fn))
    return chip_smoke.main(argv)


if __name__ == "__main__":
    sys.exit(main())
