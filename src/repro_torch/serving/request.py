"""The unit of serving work: one prompt -> one bounded generation.

A copy of ``repro/serving/request.py`` (pure Python; the port imports
nothing from ``repro``).

A request owns its PRNG seed, so sampled generations are a function of
the request alone — never of which strangers happened to share its batch
(the batch-composition invariance the parity suite seals).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    prompt: tuple  # token ids
    max_tokens: int
    #: generation stops when this token is emitted (it is included in the
    #: output) or when max_tokens is reached, whichever comes first
    eos_id: Optional[int] = None
    #: soft latency target (submit -> done), recorded per request so the
    #: engine's metrics can attribute SLO misses; admission stays FCFS
    slo_ms: Optional[float] = None
    #: per-request PRNG seed for sampling (greedy decode ignores it)
    seed: int = 0
    #: optional VLM prefix embeddings, (P, d_model) — threaded to prefill
    img_embeds: Optional[Any] = None
    #: priority class (higher = more important).  With a priority-aware
    #: ShedPolicy, admission pops higher classes first and a shrinking
    #: pool evicts lower classes to the spill path first; otherwise
    #: recorded but inert (admission stays FCFS).
    priority: int = 0
    #: admission deadline in scheduler ticks from submission: still
    #: queued after this many ticks -> typed-rejected ("deadline").
    #: None defers to the policy-level default (ShedPolicy.deadline_ticks).
    deadline_ticks: Optional[int] = None

    def __post_init__(self):
        if self.max_tokens <= 0:
            raise ValueError(f"request {self.rid}: max_tokens must be >= 1")
        if len(self.prompt) == 0:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.deadline_ticks is not None and self.deadline_ticks < 0:
            raise ValueError(
                f"request {self.rid}: deadline_ticks must be >= 0")


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: list
    #: wall-clock milestones (engine-relative seconds)
    submit_s: float = 0.0
    admit_s: float = 0.0
    first_token_s: float = 0.0
    done_s: float = 0.0
    #: scheduler-tick milestones (engine tick counter; -1 = not reached).
    #: Wall-clock varies run to run, but tick indices are deterministic
    #: for a given arrival order, so latency *structure* (how many ticks
    #: a request queued, how long it decoded) is recoverable from any
    #: saved artifact.
    enqueue_tick: int = -1
    first_token_tick: int = -1
    finish_tick: int = -1
    slot: int = -1
    finished_by: str = "max_tokens"  # "eos" | "max_tokens" | "rejected"
    #: typed rejection reason ("queue_full" | "deadline") — None when the
    #: request was (or will be) served.  A rejected request has no tokens
    #: and its finished_by is "rejected"; nothing is ever dropped without
    #: one of these two markers (the spring-survive no-silent-loss seal).
    rejected: Optional[str] = None

    @property
    def status(self) -> str:
        if self.rejected is not None:
            return "rejected"
        return "completed" if self.finish_tick >= 0 else "pending"

    @property
    def latency_s(self) -> float:
        return self.done_s - self.submit_s

    @property
    def queue_s(self) -> float:
        return self.admit_s - self.submit_s

    @property
    def decode_ticks(self) -> int:
        """Ticks spent decoding (first token -> finish), -1 if unfinished."""
        if self.first_token_tick < 0 or self.finish_tick < 0:
            return -1
        return self.finish_tick - self.first_token_tick + 1

    def slo_met(self, req: Request) -> Optional[bool]:
        if req.slo_ms is None:
            return None
        return self.latency_s * 1e3 <= req.slo_ms


def make_requests(prompts: Sequence[Sequence[int]], max_tokens: int,
                  *, eos_id: Optional[int] = None, seed: int = 0,
                  slo_ms: Optional[float] = None,
                  img_embeds=None) -> list[Request]:
    """Batch constructor: one request per prompt, rid = submission order,
    per-request seeds folded off the base ``seed``."""
    return [
        Request(rid=i, prompt=tuple(int(t) for t in p), max_tokens=max_tokens,
                eos_id=eos_id, slo_ms=slo_ms, seed=seed + i,
                img_embeds=None if img_embeds is None else img_embeds[i])
        for i, p in enumerate(prompts)
    ]
