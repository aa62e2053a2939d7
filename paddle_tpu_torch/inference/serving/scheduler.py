"""Continuous-batching scheduler: the policy half of the serving subsystem.

Reference frame: vLLM's scheduler / PaddleNLP's block-attention batch
builder. Every engine step serves ONE fixed token budget shared by chunked
prefill and decode (the MPK argument from PAPERS.md: collapse the ragged
request mix into one fixed-shape compiled program):

- **admission control / load shedding**: ``add_request`` raises
  :class:`RejectedError` the moment the wait queue holds ``max_queue``
  requests — backpressure surfaces at the edge instead of as unbounded
  latency;
- **chunked prefill**: long prompts are fed ``prefill_chunk`` tokens at a
  time, interleaved with running decodes in the same step, so admission
  never stalls in-flight tokens for a whole prompt's worth of compute;
- **preemption under block exhaustion**: when the KV pool cannot grow a
  running sequence, the lowest-priority / youngest sequence is evicted —
  its pages freed, its state reset to recompute-on-resume (prompt +
  generated tokens re-prefill when capacity returns, numerically exact);
- **deadlines & cancellation**: per-request absolute deadlines checked at
  every schedule point; expired or cancelled requests free their pages
  immediately and finish with reason ``"deadline"`` / ``"cancelled"``.

The scheduler owns sequence state and the
:class:`~.block_manager.BlockManager`; the engine owns device state and
asks ``schedule()`` for the next mixed batch.

A copy of `paddle_tpu/inference/serving/scheduler.py`: the reference's
metric emits and tracing spans become counters in ``stats``, and
``FLAGS_serving_max_queue`` becomes the ``max_queue`` default (128).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from .block_manager import BlockManager, NoFreeBlocksError

__all__ = ["RejectedError", "DeadlineExceededError", "Sequence",
           "ScheduledBatch", "Scheduler"]

DEFAULT_MAX_QUEUE = 128


class RejectedError(RuntimeError):
    """Load-shed signal: the serving queue is full. Clients should back
    off and retry; the request was NOT enqueued."""


class DeadlineExceededError(RuntimeError):
    """A request's deadline expired mid-flight: the scheduler freed its
    pages and finished it with reason ``"deadline"``. Raised through
    ``stream(rid)`` so streaming clients see a typed failure instead of a
    silently truncated token stream (``run()`` still returns the
    completion with ``finish_reason == "deadline"``)."""


WAITING, RUNNING, FINISHED = "waiting", "running", "finished"


@dataclass(eq=False)   # identity semantics: sequences live in sets/lists
class Sequence:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos: int = -1                       # -1 = no eos
    priority: int = 0                   # higher = evicted later
    deadline: Optional[float] = None    # absolute time.monotonic()
    temperature: float = 0.0            # 0 = greedy
    top_p: float = 1.0
    seed: int = 0
    # LoRA adapter this request decodes through (None = base model);
    # pinned in the AdapterManager while the sequence is live
    adapter: Optional[str] = None
    # mutable state
    tokens: List[int] = field(default_factory=list)  # prompt + generated
    generated: List[int] = field(default_factory=list)
    num_computed: int = 0
    status: str = WAITING
    preemptions: int = 0
    arrival: float = 0.0
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    finish_reason: Optional[str] = None

    def __post_init__(self):
        self.tokens = list(self.prompt)

    def remaining(self) -> int:
        return len(self.tokens) - self.num_computed


@dataclass
class ScheduledBatch:
    """One engine step's worth of work: per sequence, how many of its
    pending tokens to run (decode rows have n=1 and num_computed ==
    len(tokens)-1; prefill rows chew through larger chunks)."""
    items: List[Tuple[Sequence, int]]

    def __bool__(self):
        return bool(self.items)

    @property
    def total_tokens(self) -> int:
        return sum(n for _, n in self.items)


class Scheduler:
    def __init__(self, block_manager: BlockManager, token_budget: int,
                 max_batch: int, prefill_chunk: Optional[int] = None,
                 max_queue: int = DEFAULT_MAX_QUEUE):
        if token_budget < 1 or max_batch < 1:
            raise ValueError("token_budget and max_batch must be >= 1")
        self.blocks = block_manager
        self.token_budget = int(token_budget)
        self.max_batch = int(max_batch)
        self.prefill_chunk = int(prefill_chunk or token_budget)
        self.max_queue = int(max_queue)
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []
        self._by_rid: Dict[int, Sequence] = {}
        self.stats = {"admitted": 0, "scheduled_steps": 0, "preemptions": 0,
                      "shed": 0, "deadline_expired": 0, "cancelled": 0,
                      "prefix_hit_tokens": 0}

    # -- admission --------------------------------------------------------
    def queue_depth(self) -> int:
        return len(self.waiting)

    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def add_request(self, seq: Sequence):
        if len(self.waiting) >= self.max_queue:
            self.stats["shed"] += 1
            raise RejectedError(
                f"serving queue full ({len(self.waiting)} waiting >= "
                f"max_queue={self.max_queue}); request {seq.rid} shed — "
                f"back off and resubmit")
        seq.arrival = time.monotonic()
        self.waiting.append(seq)
        self._by_rid[seq.rid] = seq
        self.stats["admitted"] += 1

    def get(self, rid: int) -> Optional[Sequence]:
        return self._by_rid.get(rid)

    def cancel(self, rid: int) -> bool:
        seq = self._by_rid.get(rid)
        if seq is None or seq.status == FINISHED:
            return False
        self._finish(seq, "cancelled")
        self.stats["cancelled"] += 1
        return True

    # -- lifecycle helpers ------------------------------------------------
    def _finish(self, seq: Sequence, reason: str):
        seq.status = FINISHED
        seq.finish_reason = reason
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.waiting:
            self.waiting.remove(seq)
        if self.blocks.has_sequence(seq.rid):
            self.blocks.free_sequence(seq.rid)

    def finish(self, seq: Sequence, reason: str):
        self._finish(seq, reason)

    def _preempt(self, seq: Sequence):
        """Evict a running sequence: free its pages, reset to
        recompute-on-resume (the whole prompt+generated re-prefills when
        capacity returns — exactness over cache-migration complexity)."""
        self.blocks.free_sequence(seq.rid)
        seq.num_computed = 0
        seq.status = WAITING
        seq.preemptions += 1
        self.running.remove(seq)
        self.waiting.appendleft(seq)   # resumes ahead of new arrivals
        self.stats["preemptions"] += 1

    def _preempt_one(self, exclude) -> bool:
        """Evict the lowest-priority (then youngest) running sequence not
        in `exclude`; False when there is nothing left to evict."""
        victims = [s for s in self.running if s not in exclude]
        if not victims:
            return False
        victim = min(victims, key=lambda s: (s.priority, -s.arrival))
        self._preempt(victim)
        return True

    def _expire_deadlines(self) -> List[Sequence]:
        now = time.monotonic()
        expired = [s for s in list(self.running) + list(self.waiting)
                   if s.deadline is not None and now > s.deadline]
        for seq in expired:
            self._finish(seq, "deadline")
            self.stats["deadline_expired"] += 1
        return expired

    # -- the step builder -------------------------------------------------
    def schedule(self) -> Tuple[ScheduledBatch, List[Sequence]]:
        """Build the next mixed prefill+decode batch. Returns (batch,
        expired) where expired sequences hit their deadline and finished
        without compute."""
        expired = self._expire_deadlines()
        budget = self.token_budget
        items: List[Tuple[Sequence, int]] = []
        scheduled = set()

        # 1) running sequences first (decode steps and in-flight prefills):
        #    starving them for new admissions would throw away paid-for KV
        for seq in list(self.running):
            if budget <= 0 or len(items) >= self.max_batch:
                break
            if seq.status != RUNNING:   # preempted by an earlier iteration
                continue
            n = min(seq.remaining(), self.prefill_chunk, budget)
            if n <= 0:
                continue
            while True:
                try:
                    self.blocks.ensure_capacity(seq.rid,
                                                seq.num_computed + n)
                    break
                except NoFreeBlocksError:
                    # block exhaustion: evict the lowest-priority running
                    # sequence that is not already in this step's batch
                    if not self._preempt_one(exclude=scheduled | {seq}):
                        # nothing evictable but `seq` itself: park it and
                        # let capacity recover as the batch drains
                        self._preempt(seq)
                        break
            if seq.status != RUNNING:
                continue
            items.append((seq, n))
            scheduled.add(seq)
            budget -= n

        # 2) admit waiting sequences into leftover budget (chunked prefill)
        while self.waiting and budget > 0 and len(items) < self.max_batch:
            seq = self.waiting[0]
            try:
                cached = self.blocks.allocate_sequence(seq.rid, seq.tokens)
            except NoFreeBlocksError:
                break  # never evict running work for new admissions
            if cached:
                seq.num_computed = cached
                self.stats["prefix_hit_tokens"] += cached
            n = min(seq.remaining(), self.prefill_chunk, budget)
            self.waiting.popleft()
            seq.status = RUNNING
            self.running.append(seq)
            items.append((seq, n))
            budget -= n

        self.stats["scheduled_steps"] += 1 if items else 0
        return ScheduledBatch(items), expired

    def on_computed(self, seq: Sequence, n: int):
        """Commit a step's progress for one sequence and register freshly
        completed cache blocks in the prefix cache."""
        seq.num_computed += n
        self.blocks.register_computed(seq.rid, seq.tokens, seq.num_computed)

    def append_token(self, seq: Sequence, token: int):
        """A harvested token extends the sequence (its KV is computed by
        the NEXT step that schedules the sequence)."""
        seq.generated.append(int(token))
        seq.tokens.append(int(token))
        now = time.monotonic()
        if seq.first_token_at is None:
            seq.first_token_at = now
        seq.last_token_at = now
