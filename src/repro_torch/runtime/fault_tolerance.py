"""Fault tolerance & straggler mitigation for the training driver, the JAX
package's ``runtime/fault_tolerance.py`` (pure Python, copied).

Production story (1000+ nodes): every step is wrapped in a watchdog; each
host heartbeats; on failure the controller restarts the job and every host
reloads the LATEST step-atomic checkpoint (onto a changed mesh through
``runtime.elastic``). On one card the machinery is exercised through a failure-injection
hook (``launch.train --fail-at``; tests/test_torch_train_loop.py kills and
resumes a real training loop).

Straggler mitigation: per-step wall times feed an EWMA; a step slower than
``straggler_factor``× the EWMA marks the host a straggler, which at fleet
scale triggers hot-spare swap-in; here it is surfaced in the metrics so the
policy layer (the paper's admission controller!) can treat the pod as
degraded capacity.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional


class FailureInjector:
    """Deterministic fault injection for tests: raises at the given steps."""

    def __init__(self, fail_at: tuple = ()):
        self.fail_at = set(fail_at)
        self.fired: set = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


@dataclass
class StragglerWatchdog:
    ewma_alpha: float = 0.2
    straggler_factor: float = 2.5
    warmup_steps: int = 3
    _ewma: float = 0.0
    _n: int = 0
    events: list = field(default_factory=list)

    def observe(self, step: int, step_time: float) -> bool:
        self._n += 1
        if self._n <= self.warmup_steps:
            self._ewma = step_time if self._ewma == 0.0 else (
                0.5 * self._ewma + 0.5 * step_time)
            return False
        is_straggler = step_time > self.straggler_factor * self._ewma
        if is_straggler:
            self.events.append((step, step_time, self._ewma))
        else:
            self._ewma = (1 - self.ewma_alpha) * self._ewma \
                + self.ewma_alpha * step_time
        return is_straggler


class HeartbeatMonitor:
    """Host-liveness bookkeeping (single-process stand-in for the fleet RPC)."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0):
        self.timeout_s = timeout_s
        self.last_beat = {h: time.monotonic() for h in range(n_hosts)}

    def beat(self, host: int):
        self.last_beat[host] = time.monotonic()

    def dead_hosts(self) -> list:
        now = time.monotonic()
        return [h for h, t in self.last_beat.items()
                if now - t > self.timeout_s]


def run_with_restarts(
    train_loop: Callable[[int], int],
    *,
    max_restarts: int = 3,
    on_restart: Optional[Callable[[int, Exception], None]] = None,
) -> int:
    """Drive ``train_loop(start_step) -> final_step`` with restart-on-failure.

    ``train_loop`` is expected to resume from the latest checkpoint when
    re-entered (see ``launch.train``). Returns the final step reached.
    """
    start = 0
    for attempt in range(max_restarts + 1):
        try:
            return train_loop(start)
        except RuntimeError as e:
            if attempt == max_restarts:
                raise
            if on_restart is not None:
                on_restart(attempt, e)
            # train_loop re-reads LATEST itself; start value is advisory
            start = -1
    raise AssertionError("unreachable")
