"""Deterministic fault injection — every failure mode in the
resilience layer is driven from one seeded `FaultSchedule`, so tests
and benchmarks replay failures exactly (same seed -> same terminal
states, same recovery path).

The schedule is pure data + stateless pure functions of
(seed, identifiers): the runtime hooks (`ContinuousEngine.run`,
`train.loop.train`, `checkpoint.io.save`) *query* it and never mutate
it, which is what makes replay trivial.  `FaultSchedule()` (the empty
schedule) answers "no fault" to every query, and the hooks are written
so the empty schedule leaves the no-fault paths byte-identical.

Failure modes:

  * `DeviceGroupLoss` — a `ClusterSpec` group (or `ways` spans of a
    level) dies at step T.  The engine / train loop raises
    `DeviceLost`; a supervisor (`resilience.supervisor`) catches it,
    degrades the spec (`ClusterSpec.degrade`), re-plans, and resumes.
  * `TransientFailures` — each admission attempt of a request fails
    with probability p, deterministically per (seed, rid, attempt).
    The engine retries with exponential backoff up to its retry
    budget, then marks the request FAILED.
  * `CheckpointCrash` — the checkpoint write at step T crashes after
    k leaf files (simulating a mid-write process kill): the atomic
    tmp-dir protocol must leave the previous checkpoint intact.
  * `SlowRequest` — a request stalls for `stall_steps` decode steps
    after admission (a stuck client / straggler shard); per-request
    deadlines turn unbounded stalls into TIMED_OUT.
  * `MemoryPressure` — between two engine steps the admission limit
    shrinks by `factor` (graceful degradation: shed load before the
    engine OOMs).
"""
from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass
from typing import Optional, Tuple


def _unit_hash(*parts) -> float:
    """Deterministic uniform [0, 1) from arbitrary identifiers."""
    key = ":".join(str(p) for p in parts).encode()
    h = hashlib.blake2b(key, digest_size=8).digest()
    return int.from_bytes(h, "big") / 2.0 ** 64


@dataclass(frozen=True)
class DeviceGroupLoss:
    """Lose part of the fleet at (engine or train) step `at_step`:
    either a named heterogeneous `group`, or `ways` spans of the
    cluster `level` with that name (outermost level by default)."""

    at_step: int
    group: Optional[str] = None
    level: Optional[str] = None
    ways: int = 1

    def describe(self) -> str:
        if self.group is not None:
            return f"group={self.group}"
        return f"level={self.level or '<outermost>'} ways={self.ways}"


@dataclass(frozen=True)
class TransientFailures:
    """Each admission attempt of a request fails with probability `p`
    (deterministic per (schedule.seed, rid, attempt)); the failing
    attempt aborts after a hash-picked number of decoded tokens."""

    p: float

    def __post_init__(self):
        if not 0.0 <= self.p <= 1.0:
            raise ValueError("p must be in [0, 1]")


@dataclass(frozen=True)
class CheckpointCrash:
    """The checkpoint save at training step `at_step` crashes after
    writing `after_leaves` leaf files (before the atomic rename)."""

    at_step: int
    after_leaves: int = 0


@dataclass(frozen=True)
class SlowRequest:
    """Request `rid` stalls for `stall_steps` decode steps after every
    admission (its slot burns steps without producing tokens)."""

    rid: int
    stall_steps: int


@dataclass(frozen=True)
class MemoryPressure:
    """Between engine steps [at_step, until_step) the effective
    admission limit is `ceil(max_slots * factor)` — the engine sheds
    load instead of OOMing."""

    at_step: int
    until_step: int
    factor: float

    def __post_init__(self):
        if not 0.0 < self.factor <= 1.0:
            raise ValueError("factor must be in (0, 1]")


@dataclass(frozen=True)
class FaultSchedule:
    """Seeded, immutable fault plan.  All queries are pure functions of
    the schedule, so a run is replayable from (schedule, request set,
    engine seed) alone."""

    seed: int = 0
    device_losses: Tuple[DeviceGroupLoss, ...] = ()
    transient: Optional[TransientFailures] = None
    ckpt_crashes: Tuple[CheckpointCrash, ...] = ()
    slow: Tuple[SlowRequest, ...] = ()
    pressure: Tuple[MemoryPressure, ...] = ()

    @property
    def empty(self) -> bool:
        return (not self.device_losses and self.transient is None
                and not self.ckpt_crashes and not self.slow
                and not self.pressure)

    # -- device loss ---------------------------------------------------------

    def device_loss_at(self, step: int) -> Optional[DeviceGroupLoss]:
        """The earliest not-yet-consumed loss due at or before `step`
        (supervisors consume events with `without`)."""
        due = [e for e in self.device_losses if e.at_step <= step]
        return min(due, key=lambda e: e.at_step) if due else None

    def without(self, event) -> "FaultSchedule":
        """The schedule minus one consumed event (a supervisor resumes
        the run with this, so a handled fault does not re-fire)."""
        if isinstance(event, DeviceGroupLoss):
            return dataclasses.replace(self, device_losses=tuple(
                e for e in self.device_losses if e != event))
        if isinstance(event, CheckpointCrash):
            return dataclasses.replace(self, ckpt_crashes=tuple(
                e for e in self.ckpt_crashes if e != event))
        raise TypeError(f"cannot consume {type(event).__name__}")

    # -- transient request failures ------------------------------------------

    def attempt_fails(self, rid: int, attempt: int) -> bool:
        if self.transient is None or self.transient.p <= 0.0:
            return False
        return _unit_hash(self.seed, "transient", rid,
                          attempt) < self.transient.p

    def fail_after_tokens(self, rid: int, attempt: int,
                          max_new_tokens: int) -> Optional[int]:
        """Token count after which this attempt aborts (None = the
        attempt succeeds).  Uniform over [1, max_new_tokens]."""
        if not self.attempt_fails(rid, attempt):
            return None
        u = _unit_hash(self.seed, "fail-at", rid, attempt)
        return 1 + int(u * max_new_tokens)

    # -- checkpoint crashes --------------------------------------------------

    def checkpoint_crash_at(self, step: int) -> Optional[CheckpointCrash]:
        for e in self.ckpt_crashes:
            if e.at_step == step:
                return e
        return None

    # -- stalls / pressure ---------------------------------------------------

    def stall_steps(self, rid: int) -> int:
        return sum(s.stall_steps for s in self.slow if s.rid == rid)

    def slot_factor(self, step: int) -> float:
        """Effective admission-limit multiplier at an engine step."""
        f = 1.0
        for p in self.pressure:
            if p.at_step <= step < p.until_step:
                f = min(f, p.factor)
        return f


EMPTY_SCHEDULE = FaultSchedule()


class DeviceLost(RuntimeError):
    """Raised by a runtime hook when a `DeviceGroupLoss` fires.

    Carries everything a supervisor needs to recover:
      * `event` — the schedule entry that fired (names what died);
      * `step` — the engine / train step at which it fired;
      * `results` / `stats` — work acknowledged before the loss
        (serving: completed `RequestResult`s — these must never be
        re-run or lost);
      * `pending` — serving requests that must be re-admitted on the
        replanned engine (queued + requeued in-flight work whose KV
        state died with the devices).
    """

    def __init__(self, event: DeviceGroupLoss, step: int,
                 results=(), stats=None, pending=()):
        self.event = event
        self.step = step
        self.results = list(results)
        self.stats = stats
        self.pending = list(pending)
        super().__init__(
            f"device loss at step {step}: {event.describe()}")
