"""Straggler detection + mitigation policy (port of
`repro.runtime.straggler`, plain Python as in the JAX package).

At pod scale the dominant failure modes are (a) dead hosts and (b) slow
hosts (thermal throttling, network degradation). The monitor ingests
per-step per-host heartbeat durations and drives a policy:

  healthy   -> keep
  slow      -> if persistent (>= `patience` consecutive flags at
               > `threshold` x median), schedule replace-and-remesh
  dead      -> (missed `dead_after` heartbeats) immediate remesh

Remesh = restore the latest checkpoint on the surviving host set
(runtime/elastic.py + checkpoint.restore_sharded) with the deterministic
pipeline replaying from the checkpointed step. The adaptive engine's
`quarantine_from_monitor` turns these verdicts into quarantined ranks.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class HostState:
    last_step: int = -1
    slow_streak: int = 0
    durations: collections.deque = field(
        default_factory=lambda: collections.deque(maxlen=16))


class StragglerMonitor:
    def __init__(self, n_hosts: int, threshold: float = 2.0,
                 patience: int = 3, dead_after: int = 5):
        self.hosts: Dict[int, HostState] = {h: HostState()
                                            for h in range(n_hosts)}
        self.threshold = threshold
        self.patience = patience
        self.dead_after = dead_after
        self.current_step = 0

    def heartbeat(self, host: int, step: int, duration_s: float):
        st = self.hosts[host]
        st.last_step = max(st.last_step, step)
        st.durations.append(duration_s)
        self.current_step = max(self.current_step, step)

    def _median_duration(self) -> float:
        vals = sorted(st.durations[-1] for st in self.hosts.values()
                      if st.durations)
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def classify(self) -> Dict[int, str]:
        med = self._median_duration()
        out = {}
        for h, st in self.hosts.items():
            if self.current_step - st.last_step >= self.dead_after:
                out[h] = "dead"
                continue
            if st.durations and med > 0 and \
                    st.durations[-1] > self.threshold * med:
                st.slow_streak += 1
            else:
                st.slow_streak = 0
            out[h] = ("replace" if st.slow_streak >= self.patience
                      else ("slow" if st.slow_streak > 0 else "healthy"))
        return out

    def plan(self) -> Optional[dict]:
        """Remesh plan if any host is dead/replace-worthy, else None."""
        cls = self.classify()
        evict = [h for h, c in cls.items() if c in ("dead", "replace")]
        if not evict:
            return None
        survivors = [h for h in self.hosts if h not in evict]
        return {"evict": evict, "survivors": survivors,
                "action": "restore_latest_checkpoint_and_remesh"}
