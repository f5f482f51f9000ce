"""Fault-injection schedules for the in-process multi-host simulation.

The elastic runner's simulation (:func:`repro_torch.elastic.runner.simulate_elastic`)
advances in *ticks*: one tick = every live host trains one chunk for each
worker it owns. A :class:`FaultSchedule` is a list of :class:`FaultEvent`
applied at tick boundaries:

* ``kill``    — the host's process dies: all in-memory worker state is
  lost; its workers restart from their last store checkpoint (on the
  same host after a ``restart``, or on a survivor after work-stealing).
* ``restart`` — a previously killed host comes back empty-handed and
  reloads whatever the store has for the workers it still owns.
* ``delay``   — a straggler: the host executes nothing for ``duration``
  ticks (models preemption warnings, VM migration, slow NICs).

Schedules are either hand-written or drawn by :meth:`FaultSchedule.seeded`
from a domain-tagged ``np.random.SeedSequence`` — fully deterministic in
the seed, which is what makes the chaos matrix's bit-identity assertion
meaningful (the same schedule replays exactly). The port's copy of
``repro.elastic.faults`` (numpy only): the same seed draws the same events.
``elastic/`` is inside the port's RL003 scope (no unseeded or wall-clock
randomness), and the generator obeys it: no ``default_rng()`` without a
SeedSequence, no wall-clock anywhere.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Leading SeedSequence entropy word (see repro_torch.core.driver._SEED_DOMAIN's
# convention): fault streams can never alias any other module's numpy
# streams, whatever the user seed.
_FAULT_DOMAIN = 0xFA17

_KINDS = ("kill", "restart", "delay")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: ``kind`` applied to ``host`` at ``tick``.
    ``duration`` (ticks) is meaningful for ``delay`` only."""

    kind: str
    host: int
    tick: int
    duration: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(one of {_KINDS})")
        if self.host < 0 or self.tick < 0:
            raise ValueError("host and tick must be non-negative")
        if self.kind == "delay" and self.duration < 1:
            raise ValueError("delay events need duration >= 1")


@dataclass(frozen=True)
class FaultSchedule:
    """An ordered set of fault events, queried tick by tick."""

    events: tuple = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: (e.tick, e.host))))

    def at(self, tick: int) -> list[FaultEvent]:
        """Events firing exactly at ``tick``."""
        return [e for e in self.events if e.tick == tick]

    @property
    def last_tick(self) -> int:
        """Tick of the final event (0 when empty) — after this, no more
        faults can change which workers are runnable."""
        return max((e.tick for e in self.events), default=0)

    def killed_hosts(self) -> set[int]:
        """Hosts that die at some point (restarted or not)."""
        return {e.host for e in self.events if e.kind == "kill"}

    # ------------------------------------------------------------ seeded
    @classmethod
    def seeded(cls, seed: int, *, hosts: int, horizon: int,
               kills: int = 1, restarts: int = 0, delays: int = 0,
               max_delay: int = 3) -> "FaultSchedule":
        """Draw a random-but-reproducible schedule.

        ``kills`` distinct hosts die at ticks in ``[1, horizon)``;
        ``restarts`` of them come back at a strictly later tick;
        ``delays`` independent straggler events hit random hosts for
        1..``max_delay`` ticks. Never kills host 0's entire fleet:
        at least one host always survives un-killed (a run with no
        possible survivor tests nothing).
        """
        if hosts < 1 or horizon < 2:
            raise ValueError("need hosts >= 1 and horizon >= 2")
        kills = min(kills, hosts - 1)  # leave one survivor
        restarts = min(restarts, kills)
        rng = np.random.default_rng(
            np.random.SeedSequence((_FAULT_DOMAIN, seed, hosts, horizon)))
        events = []
        victims = rng.choice(hosts, size=kills, replace=False) if kills else []
        kill_ticks = {}
        for h in victims:
            t = int(rng.integers(1, horizon))
            kill_ticks[int(h)] = t
            events.append(FaultEvent("kill", int(h), t))
        for h in list(kill_ticks)[:restarts]:
            events.append(FaultEvent(
                "restart", h, kill_ticks[h] + int(rng.integers(1, 3))))
        for _ in range(delays):
            events.append(FaultEvent(
                "delay", int(rng.integers(0, hosts)),
                int(rng.integers(1, horizon)),
                duration=int(rng.integers(1, max_delay + 1))))
        return cls(events=tuple(events))
