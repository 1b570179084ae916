"""Live weight publishing: the continuous train -> serve loop. Twin of
``repro/serve/publish.py``.

SWAP's product is the averaged model (Algorithm 1, lines 27-28). This
module carries it into serving while training goes on:

  * ``WeightPublisher``: an epoch-boundary hook for the phase engine
    (``train.loop.run_phase``'s ``on_chunk``, ``SWAP.run(phase2_hooks=)``).
    At each boundary it folds the across-worker mean of the phase-2
    ensemble into a ``StreamingAverage`` over epochs (on the swa_avg kernel
    for CUDA tensors), then pushes the running average, a new weight
    generation, into live ``CompiledServingEngine`` replicas
    (``engine.publish``) and/or an atomic publish snapshot
    (``checkpoint.state.save_publish``).
  * ``PublishFollower``: the consumer for engines in other processes;
    tails a directory for new publish generations (``launch.serve
    --follow``). A snapshot is written then renamed, sidecar first, so a
    poll never sees a torn generation.

The swap itself is the engine's (double-buffered params, per-slot pinning:
``serve/compiled.py``); the publisher decides what to publish and when.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.checkpoint.state import (find_latest_publish, load_publish,
                                          save_publish, state_step)
from repro_torch.core.averaging import StreamingAverage, average_stacked

# the failures a retry can fix: I/O on the snapshot directory, an engine's
# delivery raising. Programming errors (TypeError, bad trees) are not
# retried.
_RETRYABLE = (OSError, RuntimeError, ValueError)


class WeightPublisher:
    """Epoch-boundary snapshot and hot swap of the running average.

    ``engines``: live ``CompiledServingEngine``s to swap in this process.
    ``directory``: a directory for atomic publish snapshots (other
    processes follow it with ``PublishFollower``). ``ensemble``: the hooked
    phase carries a leading worker axis (SWAP phase 2), averaged over
    before the fold; False for a single-model phase. ``every``: publish at
    every ``every``-th boundary. ``impl``: the ``StreamingAverage``'s
    (``kernels.dispatch``).

    Use ``publisher.on_epoch`` as a ``run_phase``/``SWAP.run`` hook, or
    call ``publish(params)`` with an averaged tree.

    Delivery: ``max_retries`` attempts a failed publish again (a snapshot
    write or an engine's delivery raising) after ``retry_backoff_s *
    2**k`` seconds (an injectable ``sleep``). Past the budget,
    ``on_failure`` decides: ``"raise"`` (the failure propagates and the
    generation counter has not moved) or ``"skip"`` (recorded in
    ``self.failures``, a warning, the current generation returned: the
    next boundary publishes a fresher average).
    """

    def __init__(self, engines=(), *, directory: Optional[str] = None,
                 ensemble: bool = True, every: int = 1, impl: str = "auto",
                 max_retries: int = 0, retry_backoff_s: float = 0.05,
                 on_failure: str = "raise",
                 sleep: Callable[[float], None] = time.sleep):
        if not engines and not directory:
            raise ValueError(
                "WeightPublisher needs somewhere to publish: pass live "
                "engines, a snapshot directory, or both")
        if on_failure not in ("raise", "skip"):
            raise ValueError(f"on_failure must be 'raise' or 'skip', "
                             f"got {on_failure!r}")
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        self.engines: List[Any] = list(engines)
        self.directory = directory
        self.ensemble = ensemble
        self.every = max(1, every)
        self.average = StreamingAverage(impl=impl)
        self.generation = 0
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.on_failure = on_failure
        self._sleep = sleep
        self._boundaries = 0
        self.log: List[Dict[str, int]] = []   # [{generation, step, folds}]
        self.failures: List[Dict[str, Any]] = []   # skipped publishes

    def attach(self, engine) -> None:
        """Add a live engine; it receives the generations published
        later."""
        self.engines.append(engine)

    def on_epoch(self, state, done: int) -> Optional[int]:
        """Fold this boundary's model into the running average and publish
        it; a ``run_phase(on_chunk=...)`` hook."""
        self._boundaries += 1
        if self._boundaries % self.every:
            return None
        params = state.bundle["params"]
        if self.ensemble:
            # the across-worker mean (phase 3's), then the fold over epochs
            params = average_stacked(params)
        avg = self.average.add(params)
        return self.publish(avg, step=state_step(state))

    def publish(self, params, step: int = 0) -> int:
        """Publish ``params`` as the next generation: the snapshot first
        (an engine is never ahead of the durable record), then the swap
        into every attached engine.

        The counter and the log advance only once the publish landed
        somewhere: a failed ``save_publish`` takes no generation number,
        and if every engine refuses the generation as stale (``publish``
        -> None) the counter rolls back. A retry runs the whole attempt
        again under the same generation number (``save_publish`` is an
        atomic overwrite)."""
        attempt = 0
        while True:
            try:
                return self._publish_once(params, step)
            except _RETRYABLE as err:
                attempt += 1
                if attempt <= self.max_retries:
                    self._sleep(self.retry_backoff_s * 2 ** (attempt - 1))
                    continue
                if self.on_failure == "raise":
                    raise
                self.failures.append(
                    {"step": step, "attempts": attempt,
                     "error": f"{type(err).__name__}: {err}"})
                warnings.warn(
                    f"publish at step {step} failed after {attempt} "
                    f"attempt(s) ({err}); skipping — the next epoch "
                    f"boundary publishes a fresher average",
                    RuntimeWarning)
                return self.generation

    def _publish_once(self, params, step: int) -> int:
        gen = self.generation + 1
        if self.directory:
            save_publish(self.directory, gen, step, params,
                         meta={"folds": self.average.n})
        delivered = not self.engines
        for engine in self.engines:
            # True: swapped now, False: deferred (it will apply), None:
            # refused as stale; only non-None counts as delivered
            if engine.publish(params, generation=gen) is not None:
                delivered = True
        if not delivered:
            return self.generation                # every engine refused
        self.generation = gen
        self.log.append({"generation": gen, "step": step,
                         "folds": self.average.n})
        return gen


class PublishFollower:
    """Tail a directory for new publish generations.

    ``poll()`` returns ``(generation, params)`` when a generation newer
    than the last one seen is complete, else None; ``params`` take
    ``template``'s structure, dtypes and devices. A snapshot is renamed
    into place after its sidecar, so a poll never returns a torn write.
    """

    def __init__(self, directory: str, template):
        self.directory = directory
        self.template = template
        self.generation = 0        # newest generation already consumed

    def poll(self) -> Optional[Tuple[int, Any]]:
        latest = find_latest_publish(self.directory)
        if latest is None or latest["generation"] <= self.generation:
            return None
        params = load_publish(latest["path"], self.template)
        self.generation = latest["generation"]
        return latest["generation"], params
