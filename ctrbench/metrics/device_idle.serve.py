"""``device_idle.serve``: the share of the profiled slice of the scoring loop in which no
kernel, memcpy or memset ran on the device; on several ranks, the rank that
idles most. Nothing where a rank's busy time is not exact (``trace.py``:
its device events on several streams were not placed on the time line)."""


def read(view):
    if not all(r["busy_exact"] for r in view.readings):
        return None
    shares = [1.0 - r["busy_s"] / r["window_s"] for r in view.readings if r["window_s"] > 0]
    return 100.0 * max(shares) if shares else None
