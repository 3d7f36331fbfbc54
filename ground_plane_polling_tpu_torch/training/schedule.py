"""Learning-rate scheduling: reduce-on-plateau (port of
ground_plane_polling_tpu/training/schedule.py).

The Keras reference's ReduceLROnPlateau on the training loss (factor 0.1,
patience 2, min_delta 1e-4). A host-side state machine; the new lr is
written into the optimizer through `TrainState.lr`.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ReduceLROnPlateau"]


@dataclasses.dataclass
class ReduceLROnPlateau:
    factor: float = 0.1
    patience: int = 2
    min_delta: float = 1e-4
    min_lr: float = 0.0
    cooldown: int = 0

    best: float = float("inf")
    wait: int = 0
    cooldown_counter: int = 0

    def update(self, state, metric: float):
        """Feed the epoch metric; returns (state, reduced: bool)."""
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0

        if metric < self.best - self.min_delta:
            self.best = metric
            self.wait = 0
            return state, False

        if self.cooldown_counter > 0:
            return state, False

        self.wait += 1
        if self.wait >= self.patience:
            state.lr = max(state.lr * self.factor, self.min_lr)
            self.wait = 0
            self.cooldown_counter = self.cooldown
            return state, True
        return state, False
