"""Straggler monitoring and restore-and-retry steps for the trainers.

Port of ``repro.distributed.elastic``.

* **Checkpoint/restart** -- every step is restartable from the last
  committed checkpoint (``repro_torch.training.checkpoint``).  The
  trainers wrap each step in :func:`run_step_resilient`: a *retryable*
  failure triggers restore-and-retry with exponential backoff; repeated
  failures raise after ``max_retries``.  Only errors in :data:`RETRYABLE`
  are retried -- a retry loop that swallows every ``Exception`` turns
  caller bugs (TypeError, shape mismatch) and kernel failures into
  silent restores, so those propagate on the first attempt.
* **Re-planning** of a distributed problem onto a degraded grid lives in
  ``repro_torch.core.api.degrade``.  The reference's ``remesh`` (a JAX
  ``(data, model)`` mesh for the LM zoo) comes with that zoo.
* **Straggler mitigation** -- :class:`StepMonitor` tracks a rolling
  median of step times; a step exceeding ``straggler_factor`` x median
  is flagged: its id accumulates in ``monitor.flagged`` and the hook
  fires.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.core.api import RETRYABLE_ERRORS
from repro_torch.obs import metrics as obs_metrics

#: Errors worth a restore-and-retry: injected faults from the harness and
#: the failures of a collective or a peer.  Everything else -- a caller
#: bug, a kernel that fails to build or launch -- propagates.
RETRYABLE = RETRYABLE_ERRORS


def backoff_delays(max_retries: int, *, base: float = 0.0,
                   factor: float = 2.0, max_delay: float = 2.0,
                   jitter: float = 0.25, seed: int = 0):
    """Deterministic exponential-backoff schedule with seeded jitter.

    Yields ``max_retries`` delays: ``min(base * factor**k, max_delay)``
    scaled by ``1 + jitter * U[0,1)`` from ``np.random.default_rng(seed)``
    -- the same seed replays the same schedule.
    """
    rng = np.random.default_rng(seed)
    d = base
    for _ in range(max_retries):
        yield min(d, max_delay) * (1.0 + jitter * float(rng.uniform()))
        d = d * factor if d > 0 else base


def _synchronize(out) -> None:
    """Wait for the card work behind ``out`` (tensors, nested in tuples,
    lists and dicts): the step time includes the device's."""
    import torch
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _synchronize(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            _synchronize(v)


@dataclasses.dataclass
class StepMonitor:
    straggler_factor: float = 3.0
    window: int = 32
    clock: Callable[[], float] = time.monotonic
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    _times: list = dataclasses.field(default_factory=list)
    #: step ids flagged as stragglers, in observation order
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; returns True if flagged as straggler."""
        med = float(np.median(self._times)) if self._times else None
        self._times.append(seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        reg = obs_metrics.active()
        if reg is not None:
            reg.observe("train.step_seconds", seconds)
        if med is not None and seconds > self.straggler_factor * med:
            self.flagged.append(step)
            if reg is not None:
                reg.inc("train.stragglers")
            if self.on_straggler:
                self.on_straggler(step, seconds, med)
            return True
        return False

    def timed(self, step: int, fn, *a, **kw):
        """``fn(*a, **kw)`` timed to the end of its device work."""
        t0 = self.clock()
        out = fn(*a, **kw)
        _synchronize(out)
        self.observe(step, self.clock() - t0)
        return out


def run_step_resilient(step_fn, save_fn, restore_fn, *args,
                       max_retries: int = 2, on_failure=None,
                       retryable=RETRYABLE, backoff=None,
                       sleep=time.sleep):
    """Execute one training step with restore-and-retry semantics.

    ``step_fn`` dying with a *retryable* error (an injected
    ``TransientFault``, a failed collective or peer) triggers
    ``restore_fn() -> fresh args`` and a retry after an exponential-backoff
    delay.  Other errors propagate immediately: retrying them can only
    loop on the same deterministic failure.

    ``backoff`` is an iterable of delays (default: :func:`backoff_delays`
    with zero base delay, i.e. no sleeping); ``sleep`` is injectable for
    deterministic tests.  ``restore_fn`` may return None to retry with the
    original args.  ``save_fn`` is accepted for the reference's signature
    and not called.
    """
    del save_fn
    delays = iter(backoff if backoff is not None
                  else backoff_delays(max_retries))
    attempt = 0
    while True:
        try:
            return step_fn(*args)
        except retryable as e:
            attempt += 1
            if on_failure:
                on_failure(attempt, e)
            if attempt > max_retries:
                raise
        # outside the handler, so the failed step's frames (and the
        # device state they hold) are freed before the retry
        d = next(delays, 0.0)
        if d > 0:
            sleep(d)
        fresh = restore_fn() if restore_fn is not None else None
        if fresh is not None:
            args = fresh
