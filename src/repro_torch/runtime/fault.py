"""Fault-tolerance runtime: heartbeats, straggler detection, elastic re-mesh
planning, and a supervised restart wrapper (a copy of the reference
package's ``runtime/fault.py``: host code, numpy only, the same decisions,
defaults and messages).

On a real multi-host deployment each host runs a ``Heartbeat`` publisher and
the rank-0 ``FleetMonitor`` consumes them (file-, KV-store- or RPC-backed; the
transport here is a pluggable callback so tests can drive it synchronously).
The *decisions* — when to declare a straggler, when to shrink the mesh, what
the replacement mesh looks like, and where training resumes from — are
implemented and unit-tested here; they are transport-independent.

Recovery model (1000+ node posture):
* node loss   -> restart from the latest atomic checkpoint on a re-formed
                 mesh (``plan_remesh``): the data axis shrinks to the largest
                 feasible size, 'model' (ICI-local) stays intact;
* straggler   -> flagged by the z-score policy after ``grace`` steps; the
                 supervisor excludes it at the next restart boundary;
* restart     -> ``Supervisor.run`` wraps the train loop, catches
                 checkpoint-restorable failures and resumes with backoff.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class HostStatus:
    host_id: int
    step: int
    step_time_s: float
    timestamp: float


class FleetMonitor:
    """Consumes per-host heartbeats; decides dead hosts + stragglers."""

    def __init__(self, n_hosts: int, timeout_s: float = 60.0,
                 straggler_zscore: float = 3.0, grace_steps: int = 10):
        self.n_hosts = n_hosts
        self.timeout_s = timeout_s
        self.z = straggler_zscore
        self.grace = grace_steps
        self.status: Dict[int, HostStatus] = {}

    def heartbeat(self, hs: HostStatus):
        self.status[hs.host_id] = hs

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        dead = [h for h in range(self.n_hosts) if h not in self.status]
        dead += [h for h, s in self.status.items()
                 if now - s.timestamp > self.timeout_s]
        return sorted(set(dead))

    def stragglers(self) -> List[int]:
        if len(self.status) < max(4, self.n_hosts // 2):
            return []
        ts = np.asarray([s.step_time_s for s in self.status.values()])
        med = np.median(ts)
        mad = np.median(np.abs(ts - med)) + 1e-9
        out = []
        for h, s in self.status.items():
            if s.step > self.grace and (s.step_time_s - med) / (1.4826 * mad) > self.z:
                out.append(h)
        return sorted(out)


def plan_remesh(n_healthy_chips: int, model_axis: int = 16,
                pods: int = 1) -> Optional[Tuple[int, ...]]:
    """Largest (pod, data, model) mesh that fits the healthy chip count.
    'model' is ICI-local and must stay intact; we shrink 'data' (and then
    'pod').  Returns None if no viable mesh remains."""
    for p in range(pods, 0, -1):
        data = n_healthy_chips // (p * model_axis)
        # keep the global batch divisible: use the largest power-of-two data
        while data > 0 and (data & (data - 1)):
            data -= 1
        if data >= 1:
            return (p, data, model_axis) if pods > 1 else (data, model_axis)
    return None


class Supervisor:
    """Checkpoint-restart wrapper around a train loop.

    ``loop_fn(start_step) -> final_step`` must raise on failure and is
    expected to save checkpoints via the AsyncCheckpointer; ``restore_fn()``
    returns the step to resume from (latest checkpoint, or 0)."""

    def __init__(self, loop_fn: Callable[[int], int],
                 restore_fn: Callable[[], int],
                 max_restarts: int = 10, backoff_s: float = 1.0):
        self.loop_fn = loop_fn
        self.restore_fn = restore_fn
        self.max_restarts = max_restarts
        self.backoff_s = backoff_s
        self.restarts = 0

    def run(self) -> int:
        while True:
            start = self.restore_fn()
            try:
                return self.loop_fn(start)
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:  # noqa: BLE001 — any step failure is retryable
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"giving up after {self.restarts - 1} restarts") from e
                time.sleep(self.backoff_s * min(2 ** (self.restarts - 1), 60))
