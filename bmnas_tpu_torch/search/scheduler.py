"""Per-batch cosine-annealing LR schedule with warm restarts.

The port's own copy of ``bmnas_tpu/search/scheduler.py`` (the reference's
``models/auxiliary/scheduler.py:12-62``). The schedule is stateful (the
iteration counter resets and the period multiplies by ``Tm`` when eta
reaches eta_min) and is evaluated on the host in float64: the restart
trigger ``eta <= eta_min + 1e-10`` is a comparison that float32 cos()
would miss. One call per weight step; the eta it returns becomes the
weight optimizer's learning rate for that step. ``state`` /
``load_state`` carry a schedule through the ``--resume`` checkpoint.
"""
from __future__ import annotations

import numpy as np


class LRCosineAnnealingScheduler:
    """eta = eta_min + 0.5 (eta_max - eta_min)(1 + cos(pi * Tcur / Ti));
    restart (Ti *= Tm) when eta hits eta_min."""

    def __init__(self, eta_max: float, eta_min: float, Ti: float,
                 Tmultiplier: float, num_batches_per_epoch: float):
        self.eta_min = float(eta_min)
        self.eta_max = float(eta_max)
        self.Ti = float(Ti)
        self.Tcur = 0.0
        self.nbpe = float(num_batches_per_epoch)
        self.iteration_counter = 0.0
        self.eta = float(eta_max)
        self.Tm = float(Tmultiplier)

    def _compute_rule(self) -> float:
        self.eta = self.eta_min + 0.5 * (self.eta_max - self.eta_min) * (
            1 + np.cos(np.pi * self.Tcur / self.Ti)
        )
        return self.eta

    def step(self) -> float:
        self.Tcur = self.iteration_counter / self.nbpe
        self.iteration_counter += 1.0
        eta = self._compute_rule()
        if eta <= self.eta_min + 1e-10:
            self.Tcur = 0
            self.Ti = self.Ti * self.Tm
            self.iteration_counter = 0
        return eta

    def state(self) -> dict:
        """Python floats (eta is a numpy float after a step), so the
        checkpoint loads with ``torch.load(weights_only=True)``."""
        return {
            "Ti": float(self.Ti),
            "Tcur": float(self.Tcur),
            "iteration_counter": float(self.iteration_counter),
            "eta": float(self.eta),
        }

    def load_state(self, state: dict) -> None:
        self.Ti = state["Ti"]
        self.Tcur = state["Tcur"]
        self.iteration_counter = state["iteration_counter"]
        self.eta = state["eta"]


class FixedScheduler:
    """Constant LR."""

    def __init__(self, lr: float):
        self.lr = float(lr)
        self.eta = self.lr

    def step(self) -> float:
        return self.lr

    def state(self) -> dict:
        return {"lr": self.lr}

    def load_state(self, state: dict) -> None:
        self.lr = state["lr"]
