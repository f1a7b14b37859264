"""One runner for each kind of traffic: ``runners/<kind>.py`` with
``run(ctx) -> dict``, found by the ``kind`` of a traffic mix."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Context:
    """What a runner is handed: the cell's configuration and traffic, the
    run's seed, window and trace flag, its device, and the clock reading at
    the process's start (for ``setup_s``)."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float

    @property
    def dev(self) -> torch.device:
        return torch.device(self.device)
