"""Serving engines: static batching and continuous batching.

`Engine` is the static-batch loop (prefill once, decode N tokens for
everyone, no admission).  `ContinuousEngine` is the loop the OSDP
serving search plans for (`repro_torch.core.api.search_serve`):

  * a FIFO **request queue** feeds a fixed set of **slots** — the KV
    cache is allocated once at ``(max_slots, cache_len)`` and never
    reshaped;
  * **admission** is bounded by the searched KV budget: a request is
    admitted only when a slot is free (``max_slots`` comes from
    ``ServePlan.max_slots_per_device``);
  * **prefill/decode interleaving**: each engine iteration first
    prefills one queued request per free slot (batch 1, copied into the
    slot in place), then decodes every slot one token with a per-slot
    position vector;
  * per-request **latency stats** on the host clock, plus a
    deterministic engine-step clock for tests and benchmarks.

Slots whose request finished keep decoding garbage until re-admission
overwrites their cache — their outputs are ignored, and the admission
prefill rewrites every cache leaf of the slot.

The model runs eagerly on the device of the parameters; the engine
reads each step's tokens back to the host (which also synchronises, so
host-clock latencies are device latencies).
"""
from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.registry import Built


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tokens(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int32), device=device)


def _sample(cfg, logits: torch.Tensor, gen: torch.Generator,
            temperature: float) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32 tokens: argmax, or a draw from
    softmax(logits / temperature) with `gen` when temperature > 0."""
    logits = logits[..., :cfg.vocab_size].float()
    if temperature <= 0:
        return logits.argmax(-1).to(torch.int32)[:, None]
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


def _insert(caches: Dict[str, Dict[str, torch.Tensor]],
            one: Dict[str, Dict[str, torch.Tensor]], slot: int) -> None:
    """Copy a batch-1 prefill cache into `slot` of the slot caches, in
    place (the JAX engine's donated dynamic_update_slice)."""
    for name, leaves in one.items():
        for key, new in leaves.items():
            caches[name][key][:, slot:slot + 1].copy_(new)


# ---------------------------------------------------------------------------
# static batching
# ---------------------------------------------------------------------------

@dataclass
class GenerationResult:
    tokens: np.ndarray            # (B, n_new)
    prefill_s: float
    decode_s: float
    tokens_per_s: float


@dataclass
class Engine:
    """Static batching: one prefill, then every sequence decodes the
    same number of tokens in lockstep.  `cache_len` (>= prompt length)
    sizes the KV cache; default keeps the prompt-length rolling
    cache."""

    built: Built
    params: Dict[str, torch.Tensor]
    temperature: float = 0.0
    cache_len: Optional[int] = None

    def generate(self, prompts: np.ndarray, n_new: int,
                 seed: int = 0) -> GenerationResult:
        """prompts: (B, S) int32 token ids."""
        model = self.built.model
        cfg = model.cfg
        assert cfg.is_decoder, "encoder-only models cannot decode"
        dev = self.params["embed/tok"].device
        B, S = prompts.shape
        t0 = time.perf_counter()
        logits, caches = model.prefill(
            self.params, {"tokens": _tokens(prompts, dev)},
            cache_len=self.cache_len)
        _sync(dev)
        t1 = time.perf_counter()
        gen = _generator(dev, seed)
        out = []
        tok = _sample(cfg, logits[:, -1], gen, self.temperature)
        for i in range(n_new):
            out.append(tok.cpu().numpy())
            logits, caches = model.decode_step(self.params, caches, tok,
                                               S + i)
            tok = _sample(cfg, logits[:, 0], gen, self.temperature)
        _sync(dev)
        t2 = time.perf_counter()
        toks = np.concatenate(out, axis=1) if out else np.zeros((B, 0), int)
        return GenerationResult(
            toks, t1 - t0, t2 - t1,
            B * n_new / max(t2 - t1, 1e-9))


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

# terminal request states (RequestResult.status)
OK = "OK"                  # all max_new_tokens generated
INVALID = "INVALID"        # rejected at validation, never admitted
REJECTED = "REJECTED"      # queue-depth backpressure, never admitted
TIMED_OUT = "TIMED_OUT"    # deadline passed (queued or mid-decode)
FAILED = "FAILED"          # transient failures exhausted the retries


@dataclass(frozen=True)
class Request:
    """One serving request: a prompt, a decode budget, and optional
    deadlines.  `deadline_steps` is an absolute engine-step index by
    which the request must finish (the deterministic clock used by
    tests/benchmarks); `timeout_s` is the host-clock analogue.
    Validation happens at engine admission (`ContinuousEngine.run`
    returns an INVALID `RequestResult` for a bad request instead of
    raising mid-run and abandoning the other live slots)."""

    rid: int
    prompt: np.ndarray            # (S,) int32 token ids
    max_new_tokens: int
    deadline_steps: Optional[int] = None
    timeout_s: Optional[float] = None


@dataclass
class RequestResult:
    """Per-request output + latency accounting (host-clock seconds
    relative to `ContinuousEngine.run`'s start, plus the deterministic
    engine-step clock).  `status` is one of the terminal states OK /
    INVALID / REJECTED / TIMED_OUT / FAILED; only OK results carry a
    complete generation (TIMED_OUT / FAILED keep their partial tokens
    for inspection, but they do not count toward useful throughput)."""

    rid: int
    prompt_len: int
    tokens: np.ndarray            # (n_generated,) int32
    t_enqueued: float
    t_admitted: float
    t_first_token: float
    t_finished: float
    admitted_at_step: int
    finished_at_step: int
    status: str = OK
    attempts: int = 1
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.status == OK

    @property
    def n_generated(self) -> int:
        return int(len(self.tokens))

    @property
    def queue_wait_s(self) -> float:
        return self.t_admitted - self.t_enqueued

    @property
    def ttft_s(self) -> float:
        """Time to first token, queue wait included."""
        return self.t_first_token - self.t_enqueued

    @property
    def latency_s(self) -> float:
        return self.t_finished - self.t_enqueued


@dataclass
class ServeStats:
    """Aggregate engine counters for one `run`.  `completed` counts OK
    terminals only; `useful_tokens` counts tokens of still-live or OK
    requests (aborted attempts move theirs to `wasted_tokens`)."""

    wall_s: float
    prefill_steps: int
    decode_steps: int
    slots: int
    useful_tokens: int
    completed: int
    wasted_tokens: int = 0
    retries: int = 0
    rejected: int = 0
    invalid: int = 0
    timed_out: int = 0
    failed: int = 0

    @property
    def terminal(self) -> int:
        """Every request reached a terminal state — OK or not."""
        return (self.completed + self.rejected + self.invalid
                + self.timed_out + self.failed)

    @property
    def tokens_per_s(self) -> float:
        return self.useful_tokens / max(self.wall_s, 1e-9)

    @property
    def goodput_tokens_per_step(self) -> float:
        """OK-request tokens per decode step — the deterministic
        throughput metric fault benchmarks compare."""
        return self.useful_tokens / max(self.decode_steps, 1)

    @property
    def slot_utilization(self) -> float:
        """Useful decoded tokens / decoded slot-steps: 1.0 means no
        slot ever decoded a finished or empty sequence.  Clamped at 0
        — an all-wasted run (every attempt aborted or expired after
        its prefill) can drive useful below the prefill count."""
        produced = self.decode_steps * self.slots
        # the admission prefill also produces one token per request
        return max(0.0, (self.useful_tokens - self.prefill_steps)
                   / max(produced, 1))

    @property
    def completion_rate(self) -> float:
        """OK terminals / all terminals (0.0 for an empty run)."""
        return self.completed / max(self.terminal, 1)

    @property
    def tokens_per_request(self) -> float:
        """Useful tokens per OK request (0.0 when nothing completed —
        all-rejected and empty workloads must not divide by zero)."""
        if self.completed == 0:
            return 0.0
        return self.useful_tokens / self.completed


@dataclass
class _Entry:
    """One queue entry: the request plus its retry bookkeeping."""

    req: Request
    attempt: int = 1
    not_before: int = 0           # engine step gating re-admission


class ContinuousEngine:
    """Continuous batching over a fixed slot pool (see module docs).

    Hardening knobs (all off by default — the no-fault, no-deadline
    path is byte-identical to the pre-resilience engine):

      * `max_queue` — queue-depth backpressure: requests beyond
        `max_slots + max_queue` waiting at submission are REJECTED
        instead of queued (None = unbounded);
      * `max_retries` / `backoff_steps` — transiently-failed attempts
        (fault-injected, or a real shard error in production) are
        requeued with exponential backoff `backoff_steps * 2**(attempt
        - 1)` engine steps, then FAILED;
      * per-request `deadline_steps` / `timeout_s` — expired requests
        (queued or mid-decode) terminate TIMED_OUT, freeing the slot;
      * `faults` (a `resilience.faults.FaultSchedule` passed to `run`)
        injects device loss (raises `DeviceLost` carrying acknowledged
        results + requeueable pending work for the supervisor),
        transient failures, stalls, and admission pressure (graceful
        degradation: the effective slot count shrinks before memory
        does).
    """

    def __init__(self, built: Built, params: Dict[str, torch.Tensor],
                 max_slots: int, cache_len: int,
                 temperature: float = 0.0,
                 max_queue: Optional[int] = None,
                 max_retries: int = 2, backoff_steps: int = 2):
        cfg = built.model.cfg
        assert cfg.is_decoder, "encoder-only models cannot decode"
        if max_slots < 1 or cache_len < 1:
            raise ValueError("need max_slots >= 1 and cache_len >= 1")
        if max_retries < 0 or backoff_steps < 1:
            raise ValueError("need max_retries >= 0 and "
                             "backoff_steps >= 1")
        self.built = built
        self.params = params
        self.max_slots = int(max_slots)
        self.cache_len = int(cache_len)
        self.temperature = float(temperature)
        self.max_queue = None if max_queue is None else int(max_queue)
        self.max_retries = int(max_retries)
        self.backoff_steps = int(backoff_steps)
        self.device = params["embed/tok"].device
        self._active = False

    def _validate(self, req: Request) -> Optional[str]:
        """Reason the request can never be served, or None."""
        p = np.asarray(req.prompt)
        if p.ndim != 1 or p.size < 1:
            return "prompt must be a non-empty 1-D token array"
        if p.size > self.cache_len:
            return (f"prompt {p.size} exceeds cache_len "
                    f"{self.cache_len}")
        if req.max_new_tokens < 1:
            return "max_new_tokens must be >= 1"
        return None

    @staticmethod
    def _unserved(req: Request, status: str, error: str,
                  attempts: int = 0) -> RequestResult:
        p = np.asarray(req.prompt)
        return RequestResult(
            rid=req.rid, prompt_len=int(p.size) if p.ndim == 1 else 0,
            tokens=np.zeros(0, np.int32), t_enqueued=0.0,
            t_admitted=0.0, t_first_token=0.0, t_finished=0.0,
            admitted_at_step=0, finished_at_step=0, status=status,
            attempts=attempts, error=error)

    # -- incremental session API ---------------------------------------------
    #
    # `run` is submit-all-then-drain over these four primitives; the
    # fleet traffic simulator (the JAX package's `serving.simulator`) interleaves
    # `submit` and `step` instead, injecting arrivals between engine
    # iterations on the deterministic engine-step clock.  One iteration
    # of the legacy serve loop == one `step()` call, so the refactor
    # leaves every `run` byte-identical (same RNG split order, same
    # admission order, same terminal states).

    def start(self, seed: int = 0, faults=None) -> None:
        """Open a serve session: allocate the slot caches and reset the
        per-run bookkeeping.  `submit`/`step`/`finish` require an open
        session; `start` on an open session raises."""
        from repro_torch.resilience.faults import EMPTY_SCHEDULE
        if self._active:
            raise RuntimeError("a serve session is already open "
                               "(call finish() first)")
        B = self.max_slots
        self._faults = EMPTY_SCHEDULE if faults is None else faults
        self._results: List[RequestResult] = []
        self._n_invalid = self._n_rejected = 0
        self._queue: deque = deque()
        self._caches = self.built.model.init_caches(B, self.cache_len,
                                                    device=self.device)
        self._gen = _generator(self.device, seed)
        self._slot_req: List[Optional[Request]] = [None] * B
        self._slot_t = np.zeros(B, np.int32)    # next decode position
        self._slot_left = np.zeros(B, np.int64)  # tokens still to decode
        self._slot_toks: List[List[int]] = [[] for _ in range(B)]
        self._slot_admit: List[Tuple[float, float, int]] = \
            [(0.0, 0.0, 0)] * B
        self._slot_attempt = [1] * B
        self._slot_fail_at: List[Optional[int]] = [None] * B
        self._slot_stall = np.zeros(B, np.int64)
        self._last_tok = np.zeros((B, 1), np.int32)
        self._prefill_steps = self._decode_steps = 0
        self._engine_step = self._useful = 0
        self._wasted = self._retries = 0
        self._n_timeout = self._n_failed = 0
        self._t0 = time.perf_counter()
        self._active = True

    @property
    def active(self) -> bool:
        """A serve session is open (between `start` and `finish`)."""
        return self._active

    @property
    def engine_step(self) -> int:
        """The deterministic clock: prefills + decode steps so far."""
        return self._engine_step if self._active else 0

    @property
    def load(self) -> int:
        """Queued + in-flight requests (a router's balance signal)."""
        if not self._active:
            return 0
        return (len(self._queue)
                + sum(1 for r in self._slot_req if r is not None))

    @property
    def pending(self) -> bool:
        """Work remains: queued entries or live slots."""
        if not self._active:
            return False
        return bool(self._queue) or any(r is not None
                                        for r in self._slot_req)

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _require_active(self) -> None:
        if not self._active:
            raise RuntimeError("no open serve session (call start())")

    def submit(self, req: Request) -> Optional[RequestResult]:
        """Enqueue one request into the open session.  Returns the
        terminal `RequestResult` immediately for INVALID / REJECTED
        (backpressure) requests, None when the request was queued."""
        self._require_active()
        B = self.max_slots
        capacity = (None if self.max_queue is None
                    else B + self.max_queue)
        err = self._validate(req)
        if err is not None:
            res = self._unserved(req, INVALID, err)
            self._results.append(res)
            self._n_invalid += 1
            return res
        if capacity is not None and len(self._queue) >= capacity:
            res = self._unserved(
                req, REJECTED,
                f"backpressure: {len(self._queue)} requests already "
                f"waiting (max_slots {B} + max_queue "
                f"{self.max_queue})")
            self._results.append(res)
            self._n_rejected += 1
            return res
        self._queue.append(_Entry(req))
        return None

    def _finish_slot(self, slot: int, status: str = OK,
                     error: str = "") -> None:
        req = self._slot_req[slot]
        t_adm, t_first, step_adm = self._slot_admit[slot]
        n_tok = len(self._slot_toks[slot])
        if status != OK:
            self._useful -= n_tok
            self._wasted += n_tok
            if status == TIMED_OUT:
                self._n_timeout += 1
            elif status == FAILED:
                self._n_failed += 1
        self._results.append(RequestResult(
            rid=req.rid, prompt_len=len(req.prompt),
            tokens=np.asarray(self._slot_toks[slot], np.int32),
            t_enqueued=0.0, t_admitted=t_adm, t_first_token=t_first,
            t_finished=self._now(), admitted_at_step=step_adm,
            finished_at_step=self._engine_step, status=status,
            attempts=self._slot_attempt[slot], error=error))
        self._slot_req[slot] = None
        self._slot_toks[slot] = []

    def _abort_slot(self, slot: int) -> None:
        """Transient failure of the slot's current attempt: requeue
        with backoff, or FAILED when retries are spent."""
        req = self._slot_req[slot]
        attempt = self._slot_attempt[slot]
        if attempt <= self.max_retries:
            n_tok = len(self._slot_toks[slot])
            self._useful -= n_tok
            self._wasted += n_tok
            self._retries += 1
            self._queue.append(_Entry(
                req, attempt + 1,
                self._engine_step
                + self.backoff_steps * 2 ** (attempt - 1)))
            self._slot_req[slot] = None
            self._slot_toks[slot] = []
        else:
            self._finish_slot(slot, FAILED,
                              f"transient failure on attempt {attempt} "
                              f"(retry budget {self.max_retries} "
                              f"spent)")

    def _expired(self, req: Request) -> Optional[str]:
        if (req.deadline_steps is not None
                and self._engine_step >= req.deadline_steps):
            return (f"deadline_steps {req.deadline_steps} passed "
                    f"at engine step {self._engine_step}")
        if req.timeout_s is not None and self._now() > req.timeout_s:
            return f"timeout_s {req.timeout_s} passed"
        return None

    def _pop_admittable(self) -> Optional[_Entry]:
        """First queued entry whose backoff window opened; expires
        dead-on-arrival entries along the way.  Entries still
        backing off rotate to the tail (their FIFO position is
        already forfeit)."""
        queue = self._queue
        for _ in range(len(queue)):
            ent = queue.popleft()
            why = self._expired(ent.req)
            if why is not None:
                res = self._unserved(ent.req, TIMED_OUT,
                                     "expired in queue: " + why,
                                     attempts=ent.attempt - 1)
                res.t_finished = self._now()
                res.finished_at_step = self._engine_step
                self._results.append(res)
                self._n_timeout += 1
                continue
            if ent.not_before <= self._engine_step:
                return ent
            queue.append(ent)
        return None

    def step(self) -> Tuple[List[int], List[RequestResult]]:
        """One engine iteration: admissions (one prefill per free
        slot), then one batched decode step.  Returns (rids whose
        first token was produced this step, results that reached a
        terminal state this step).  Idle sessions no-op."""
        from repro_torch.resilience.faults import DeviceLost
        self._require_active()
        faults = self._faults
        cfg = self.built.model.cfg
        B = self.max_slots
        queue = self._queue
        slot_req = self._slot_req
        if not queue and not any(r is not None for r in slot_req):
            return [], []
        n_before = len(self._results)
        ev = faults.device_loss_at(self._engine_step)
        if ev is not None:
            pending = [slot_req[i] for i in range(B)
                       if slot_req[i] is not None]
            pending += [e.req for e in queue]
            stats = self._session_stats()
            self._active = False
            raise DeviceLost(ev, self._engine_step,
                             results=self._results, stats=stats,
                             pending=pending)
        eff = B
        if not faults.empty:
            eff = max(1, min(B, int(math.ceil(
                B * faults.slot_factor(self._engine_step)))))
        # --- admission: one prefill per free slot ----------------------------
        admitted: List[int] = []
        n_live = sum(1 for r in slot_req if r is not None)
        for slot in range(B):
            if not queue:
                break
            if slot_req[slot] is not None:
                continue
            if n_live >= eff:
                break
            ent = self._pop_admittable()
            if ent is None:
                break
            req = ent.req
            t_adm = self._now()
            S = len(req.prompt)
            logits, one = self.built.model.prefill(
                self.params, {"tokens": _tokens(req.prompt[None],
                                                self.device)},
                cache_len=self.cache_len)
            _insert(self._caches, one, slot)
            tok = _sample(cfg, logits[:, -1], self._gen,
                          self.temperature).cpu().numpy()
            self._prefill_steps += 1
            self._engine_step += 1
            self._useful += 1
            n_live += 1
            admitted.append(req.rid)
            slot_req[slot] = req
            self._slot_attempt[slot] = ent.attempt
            self._slot_fail_at[slot] = faults.fail_after_tokens(
                req.rid, ent.attempt, req.max_new_tokens)
            self._slot_stall[slot] = faults.stall_steps(req.rid)
            self._slot_t[slot] = S
            self._slot_left[slot] = req.max_new_tokens - 1
            self._slot_toks[slot] = [int(tok[0, 0])]
            self._slot_admit[slot] = (t_adm, self._now(),
                                      self._engine_step)
            self._last_tok[slot] = tok[0]
            if (self._slot_fail_at[slot] is not None
                    and len(self._slot_toks[slot])
                    >= self._slot_fail_at[slot]):
                self._abort_slot(slot)
                n_live -= 1
            elif self._slot_left[slot] == 0:
                self._finish_slot(slot)
                n_live -= 1

        active = [i for i in range(B) if slot_req[i] is not None]
        if not active:
            if queue:
                # every queued entry is backing off: burn one
                # engine step so their windows eventually open
                self._engine_step += 1
            return admitted, list(self._results[n_before:])
        # --- one batched decode step at per-slot positions -------------------
        logits, self._caches = self.built.model.decode_step(
            self.params, self._caches, _tokens(self._last_tok, self.device),
            _tokens(self._slot_t, self.device))
        toks = _sample(cfg, logits[:, 0], self._gen,
                       self.temperature).cpu().numpy()
        self._decode_steps += 1
        self._engine_step += 1
        for i in active:
            stalled = self._slot_stall[i] > 0
            if stalled:
                # a stuck request burns the step without producing
                self._slot_stall[i] -= 1
            else:
                self._slot_toks[i].append(int(toks[i, 0]))
                self._slot_t[i] += 1
                self._slot_left[i] -= 1
                self._last_tok[i] = toks[i]
                self._useful += 1
            if (not stalled and self._slot_fail_at[i] is not None
                    and len(self._slot_toks[i])
                    >= self._slot_fail_at[i]):
                self._abort_slot(i)
            elif self._slot_left[i] == 0 and not stalled:
                self._finish_slot(i)
            else:
                why = self._expired(slot_req[i])
                if why is not None:
                    self._finish_slot(i, TIMED_OUT, why)
        return admitted, list(self._results[n_before:])

    def _session_stats(self) -> ServeStats:
        return self._stats(
            self._now(), self._prefill_steps, self._decode_steps,
            self._useful, self._results, self._wasted, self._retries,
            self._n_rejected, self._n_invalid, self._n_timeout,
            self._n_failed)

    def finish(self) -> Tuple[List[RequestResult], ServeStats]:
        """Close the session: (results in completion order, stats)."""
        self._require_active()
        _sync(self.device)
        stats = self._session_stats()
        results = self._results
        self._active = False
        self._caches = None     # free the slot caches
        return results, stats

    def run(self, requests: Sequence[Request], seed: int = 0,
            faults=None) -> Tuple[List[RequestResult], ServeStats]:
        """Serve `requests` (FIFO) to a terminal state each; returns
        per-request results in completion order plus aggregate stats.

        With a `FaultSchedule`, injected failures play out
        deterministically (same seed -> same terminal states); an
        injected device loss raises `resilience.faults.DeviceLost`
        carrying the acknowledged results and the pending requests a
        supervisor must re-admit on the replanned engine."""
        self.start(seed, faults)
        for r in requests:
            self.submit(r)
        while self.pending:
            self.step()
        return self.finish()

    def _stats(self, wall_s, prefill_steps, decode_steps, useful,
               results, wasted, retries, n_rejected, n_invalid,
               n_timeout, n_failed) -> ServeStats:
        return ServeStats(
            wall_s=wall_s, prefill_steps=prefill_steps,
            decode_steps=decode_steps, slots=self.max_slots,
            useful_tokens=useful,
            completed=sum(1 for r in results if r.status == OK),
            wasted_tokens=wasted, retries=retries, rejected=n_rejected,
            invalid=n_invalid, timed_out=n_timeout, failed=n_failed)
