"""``nccl_ms_per_step.train4``: the device time of the NCCL kernels per step
(every op whose name holds ``nccl``), the slowest rank."""


def read(view):
    per_rank = []
    for r in view.readings:
        seconds = sum(s for op, (s, _) in r["ops"].items() if "nccl" in op.lower())
        if seconds > 0 and r["steps"]:
            per_rank.append(seconds / r["steps"] * 1e3)
    return max(per_rank) if per_rank else None
