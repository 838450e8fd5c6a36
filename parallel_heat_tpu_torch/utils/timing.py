"""Wall-clock timing with device synchronisation.

PyTorch returns from a CUDA launch before the card has finished, so a
bare ``perf_counter`` delta measures the enqueue. ``Timer`` synchronises
the given device before it reads the clock, at both ends.
"""

from __future__ import annotations

import time
from typing import Optional

import torch


def synchronize(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Timer:
    """Context-manager wall-clock timer that synchronises ``device``
    (a CUDA device; the CPU needs no synchronisation)."""

    def __init__(self, device: Optional[object] = None):
        self._device = device
        self.elapsed_s: float = 0.0

    def __enter__(self):
        if self._device is not None:
            synchronize(self._device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def stop(self) -> float:
        if self._device is not None:
            synchronize(self._device)
        self.elapsed_s = time.perf_counter() - self._t0
        return self.elapsed_s
