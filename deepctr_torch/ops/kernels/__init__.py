"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each wrapper counts its launches in a module-level integer
(``mlp.LAUNCHES``, ``mlp.DROPOUT_LAUNCHES``, ``mlp.BWD_LAUNCHES``,
``interaction.LAUNCHES``). Under CUDA graph capture a wrapper runs but
launches nothing; the graph's replays launch what it recorded. So
``train/step.py``'s graphs take back what their capture counted
(:func:`launch_counts` before and after, :func:`add_launch_counts` of the
negated difference) and add that difference at every replay.
"""

from __future__ import annotations

_COUNTERS = (("mlp", "LAUNCHES"), ("mlp", "DROPOUT_LAUNCHES"),
             ("mlp", "BWD_LAUNCHES"), ("interaction", "LAUNCHES"))


def _modules():
    from . import interaction, mlp

    return {"mlp": mlp, "interaction": interaction}


def launch_counts() -> tuple[int, ...]:
    """Every launch counter, in a fixed order."""
    mods = _modules()
    return tuple(getattr(mods[m], name) for m, name in _COUNTERS)


def add_launch_counts(delta: tuple[int, ...]) -> None:
    """Add ``delta`` (in :func:`launch_counts`' order) to the counters."""
    mods = _modules()
    for (m, name), d in zip(_COUNTERS, delta, strict=True):
        setattr(mods[m], name, getattr(mods[m], name) + d)
