"""Frame-time feedback controllers (port of
``nerf_texture_tpu/viewer/controllers.py``).

The viewer tunes its load from measured frame times: training steps per
frame toward 500 ms (1..16 steps), the render's downscale toward 200 ms
(4x..1x), measured with the host's clock around calls that end in a
host sync (the training loss, the frame's pixels)."""

from __future__ import annotations

import time


class TrainStepController:
    """Steps per frame toward a frame-time budget."""

    def __init__(self, target_ms: float = 500.0, min_steps: int = 1,
                 max_steps: int = 16, initial: int = 16):
        self.target_ms = target_ms
        self.min_steps = min_steps
        self.max_steps = max_steps
        self.steps = initial

    def update(self, elapsed_ms: float) -> int:
        if elapsed_ms > 0:
            per_step = elapsed_ms / max(self.steps, 1)
            ideal = self.target_ms / max(per_step, 1e-6)
            self.steps = int(min(self.max_steps,
                                 max(self.min_steps, round(ideal))))
        return self.steps


class ResolutionController:
    """A render downscale factor toward a frame-time budget, in discrete
    tiers."""

    TIERS = (4, 3, 2, 1)   # downscale factors

    def __init__(self, target_ms: float = 200.0, initial_tier: int = 0):
        self.target_ms = target_ms
        self.tier = initial_tier
        # False freezes the tier (the viewer's dynamic-resolution toggle)
        self.enabled = True

    @property
    def downscale(self) -> int:
        return self.TIERS[self.tier]

    def update(self, elapsed_ms: float) -> int:
        if not self.enabled:
            return self.downscale
        if elapsed_ms > 1.5 * self.target_ms and self.tier > 0:
            self.tier -= 1
        elif elapsed_ms < 0.5 * self.target_ms \
                and self.tier < len(self.TIERS) - 1:
            self.tier += 1
        return self.downscale


class FrameTimer:
    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ms = (time.perf_counter() - self.t0) * 1000.0
