"""Frame timer with fixed/variable timestep.

JAX replacement for ``StepTimer``
(/root/reference/include/utils/StepTimer.h:15-183). Uses
``time.perf_counter_ns`` instead of QPC; keeps the reference's 10 MHz tick
convention and 1/4-second discontinuity clamp.
"""

from __future__ import annotations

import time

TICKS_PER_SECOND = 10_000_000  # reference convention (StepTimer.h:59)


class StepTimer:
    def __init__(self):
        self._last_ns = time.perf_counter_ns()
        self._elapsed_ticks = 0
        self._total_ticks = 0
        self._frame_count = 0
        self._fps = 0
        self._frames_this_second = 0
        self._second_counter_ns = 0
        self.is_fixed_timestep = False
        self.target_elapsed_ticks = TICKS_PER_SECOND // 60
        self._leftover_ticks = 0

    # -- conversions ---------------------------------------------------- #
    @staticmethod
    def ticks_to_seconds(ticks: int) -> float:
        return ticks / TICKS_PER_SECOND

    @property
    def elapsed_seconds(self) -> float:
        return self.ticks_to_seconds(self._elapsed_ticks)

    @property
    def total_seconds(self) -> float:
        return self.ticks_to_seconds(self._total_ticks)

    @property
    def frame_count(self) -> int:
        return self._frame_count

    @property
    def frames_per_second(self) -> int:
        return self._fps

    def reset_elapsed_time(self) -> None:
        self._last_ns = time.perf_counter_ns()
        self._leftover_ticks = 0
        self._fps = 0
        self._frames_this_second = 0
        self._second_counter_ns = 0

    def tick(self, update=None) -> None:
        now_ns = time.perf_counter_ns()
        delta_ns = now_ns - self._last_ns
        self._last_ns = now_ns
        self._second_counter_ns += delta_ns

        # Clamp excessively large deltas (e.g. paused in debugger) to 1/10 s,
        # mirroring StepTimer's MaxDelta clamp (StepTimer.h:102-106).
        delta_ns = min(delta_ns, 100_000_000)
        delta_ticks = delta_ns * TICKS_PER_SECOND // 1_000_000_000

        last_frame = self._frame_count
        if self.is_fixed_timestep:
            self._leftover_ticks += delta_ticks
            while self._leftover_ticks >= self.target_elapsed_ticks:
                self._elapsed_ticks = self.target_elapsed_ticks
                self._total_ticks += self.target_elapsed_ticks
                self._leftover_ticks -= self.target_elapsed_ticks
                self._frame_count += 1
                if update:
                    update()
        else:
            self._elapsed_ticks = delta_ticks
            self._total_ticks += delta_ticks
            self._frame_count += 1
            if update:
                update()

        if self._frame_count != last_frame:
            self._frames_this_second += self._frame_count - last_frame
        if self._second_counter_ns >= 1_000_000_000:
            self._fps = self._frames_this_second
            self._frames_this_second = 0
            self._second_counter_ns %= 1_000_000_000
