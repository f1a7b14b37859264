"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each wrapper counts its launches in a module-level integer
(``mlp.LAUNCHES``, ``mlp.DROPOUT_LAUNCHES``, ``mlp.BWD_LAUNCHES``,
``interaction.LAUNCHES``, ``stamp.LAUNCHES``, ``sparse.LAUNCHES``,
``dense.BWD_LAUNCHES``, ``dense.BWD_LIBRARY``: the dense layers'
backward products its shape rule sent to cuBLAS, and ``cin_kernel.LAUNCHES``:
``kernels/cin.py``'s launches, the CIN's products), ``ops/pool.py`` the
ids the train steps gather (``pool.OCCURRENCES``), and ``ops/cin.py`` the
CIN's outer-product bytes and products (``cin.OUTER_BYTES``,
``cin.PRODUCTS``).
:func:`launch_counts` reads them all, by name. Under CUDA graph capture a
wrapper runs but launches nothing; the graph's replays launch what it
recorded. So ``train/step.py``'s graphs take back what their capture
counted (:func:`launch_counts` before and after, :func:`add_launch_counts`
of the negated difference) and add that difference at every replay.
"""

from __future__ import annotations

# the counters, named "<module>.<counter>"
COUNTERS = ("mlp.LAUNCHES", "mlp.DROPOUT_LAUNCHES", "mlp.BWD_LAUNCHES",
            "interaction.LAUNCHES", "stamp.LAUNCHES", "sparse.LAUNCHES",
            "dense.BWD_LAUNCHES", "dense.BWD_LIBRARY", "pool.OCCURRENCES",
            "cin.OUTER_BYTES", "cin.PRODUCTS", "cin_kernel.LAUNCHES")
# the tower's and the FM scorer's counters under the names the tools report
TOWER_NAMES = {"fwd": "mlp.LAUNCHES", "fwd_dropout": "mlp.DROPOUT_LAUNCHES",
               "bwd": "mlp.BWD_LAUNCHES", "fm_score": "interaction.LAUNCHES"}


def _modules():
    from .. import cin, pool
    from . import cin as cin_kernel
    from . import dense, interaction, mlp, sparse, stamp

    return {"mlp": mlp, "interaction": interaction, "stamp": stamp, "sparse": sparse,
            "dense": dense, "pool": pool, "cin": cin, "cin_kernel": cin_kernel}


def launch_counts() -> dict[str, int]:
    """Every launch counter, by its name in :data:`COUNTERS`."""
    mods = _modules()
    return {key: getattr(mods[key.split(".")[0]], key.split(".")[1]) for key in COUNTERS}


def count_difference(after: dict[str, int], before: dict[str, int]) -> dict[str, int]:
    """``after - before``, counter by counter."""
    return {key: after[key] - before[key] for key in COUNTERS}


def tower_launches(counts: dict[str, int]) -> dict[str, int]:
    """The entries of ``counts`` named in :data:`TOWER_NAMES`, under those names."""
    return {name: counts[key] for name, key in TOWER_NAMES.items()}


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (by name, as :func:`launch_counts` gives) to the counters."""
    mods = _modules()
    for key, d in delta.items():
        m, name = key.split(".")
        setattr(mods[m], name, getattr(mods[m], name) + d)
