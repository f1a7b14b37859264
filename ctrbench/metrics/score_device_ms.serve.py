"""``score_device_ms.serve``: the device time of every kernel, memcpy and
memset of the profiled slice per request scored."""


def read(view):
    per = [sum(s for s, _ in r["ops"].values()) / r["requests"] * 1e3
           for r in view.readings if r["requests"] and r["ops"]]
    return per[0] if per else None
