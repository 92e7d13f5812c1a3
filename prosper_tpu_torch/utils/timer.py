"""Wall-clock timer, the equivalent of the reference's chrono Timer
(utils/Timer.hpp); a copy of prosper_tpu/utils/timer.py."""

from __future__ import annotations

import time


class Timer:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._start = time.perf_counter()

    def get_seconds(self) -> float:
        return time.perf_counter() - self._start

    def get_millis(self) -> float:
        return self.get_seconds() * 1e3
