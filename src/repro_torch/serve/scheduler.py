"""Continuous batching schedulers: paged (block-table) and dense (slot).

Port of ``repro/serve/scheduler.py``; the scheduling logic is the JAX
package's, line for line, so tick-based reports agree.

``ContinuousBatcher`` is the paged scheduler: requests share one pool of
fixed-size KV blocks (``serve.paged_cache.BlockPool`` on the host,
``models.init_paged_cache`` on the device), so the number of requests
in flight is bounded by cache memory, not by a preallocated
``(L, n_slots, cache_len, ...)`` worst-case shape.  Each tick:

  1. admit + prefill: FIFO head-of-line admission from the queue into
     free lanes (blocks for the whole prompt are claimed up front);
     every prefilling lane then advances at most ONE chunk
     (``chunk_size`` tokens) through ``prefill_chunk_paged``.  A request
     that finishes at prefill retires at once and its lane is re-scanned
     within the same tick.
  2. decode: all fully-prefilled lanes take one ``decode_step_paged``
     in lockstep at their own positions.  Decode blocks are allocated
     on demand; a lane that cannot get its next block stalls and
     retries next tick.  If EVERY decode lane is stalled the youngest
     admission is preempted and requeued at the FRONT of the queue,
     keeping its generated tokens (resume re-prefills prompt +
     generated).

``DenseBatcher`` is the fixed-slot reference arm: one dense
``(L, n_slots, cache_len, ...)`` cache and whole-prompt prefill into a
slot row.

Where the port differs from the JAX package: sampling uses the
counter-based ``torch.Generator`` streams of ``repro_torch.serve``
(seeded from (seed, rid, n_generated)), so sampled output is
independent of scheduling and preemption; the dense arm's prefill runs
with ``use_kernels=True`` (the flash and scan kernels on the card);
cache writes (the dense slot rows, the paged scatters, the SSM lane
state) are in place; every tick runs under ``torch.inference_mode()``;
a request that does not fit raises ``ValueError`` (JAX asserts), and so
does an encoder-decoder config.  Both batchers serve every decoder-only
family ``models`` runs (a VLM text-only: requests carry no prefix).  An
SSM request's prompt still claims paged blocks in ``ContinuousBatcher``
(the host accounting is the JAX package's), though only attention
writes them.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig
from repro_torch.serve import sample_batched, stream
from repro_torch.serve.paged_cache import BlockPool


@dataclass
class Request:
    rid: int
    tokens: List[int]                    # prompt
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)
    temperature: float = 0.0             # 0 = greedy
    top_k: int = 0                       # 0 = no top-k filter

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class BudgetExceeded(RuntimeError):
    """Raised by ``run(on_budget="raise")`` when the step budget is hit
    with work outstanding.  ``.pending`` lists the unfinished requests
    (in-flight first, then queued)."""

    def __init__(self, pending: List[Request]):
        super().__init__(f"step budget exhausted with {len(pending)} "
                         "unfinished requests")
        self.pending = pending


@dataclass
class ServeReport:
    """Deterministic tick-based metrics from ``run_trace``."""
    ticks: int
    idle_ticks: int
    requests_finished: int
    requests_pending: int
    tokens: int
    tokens_per_tick: float
    p50_latency: float                   # submit -> finish, ticks
    p99_latency: float
    p50_ttft: float                      # submit -> first token, ticks
    max_concurrency: int                 # peak simultaneously-resident
    mean_occupancy: float                # resident lanes / n_lanes
    peak_blocks: int                     # 0 for the dense batcher
    preemptions: int


class _BatcherBase:
    """Queue / budget / metrics machinery shared by both batchers."""

    def __init__(self, params, cfg: ModelConfig, n_lanes: int, seed: int):
        if cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is an encoder-decoder: the "
                             "batchers serve decoder-only models")
        self.params = params
        self.device = params.device
        self.cfg = cfg
        self.n_lanes = n_lanes
        self.seed = seed
        self.queue: Deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        self.steps = 0
        self.idle_ticks = 0
        self.preemptions = 0
        self.lane_req: List[Optional[Request]] = [None] * n_lanes
        self.pos = np.zeros((n_lanes,), np.int64)       # next position
        self.last_token = np.zeros((n_lanes,), np.int64)
        self._lane_order = np.zeros((n_lanes,), np.int64)
        self._admit_counter = 0
        self._arrive: Dict[int, int] = {}
        self._admit_seq: Dict[int, int] = {}   # rid -> first-admission order
        self._first_tok: Dict[int, int] = {}
        self._finish: Dict[int, int] = {}
        self._occupancy: List[int] = []
        self._peak_blocks = 0

    # -------------------------------------------------------------- API
    def submit(self, req: Request) -> None:
        self._validate(req)
        self._arrive.setdefault(req.rid, self.steps)
        self.queue.append(req)

    @property
    def pending(self) -> List[Request]:
        """Unfinished requests: in-flight (admission order), then queued."""
        return self._inflight() + list(self.queue)

    def step(self) -> bool:
        """One scheduler tick.  Returns whether any work happened."""
        with torch.inference_mode():
            worked = self._tick()
        if worked:
            self.steps += 1
            self._occupancy.append(self._busy_count())
        return worked

    def run(self, max_steps: int = 10_000, *,
            on_budget: str = "return") -> Dict[int, Request]:
        """Drive until queue and lanes drain or the step budget is hit.

        On budget exhaustion unfinished requests are NOT lost: they stay
        queued/in-flight (``self.pending``; ``run`` may be called again
        to resume).  ``on_budget="raise"`` raises ``BudgetExceeded``
        carrying the pending list instead of returning."""
        if on_budget not in ("return", "raise"):
            raise ValueError(f"on_budget={on_budget!r}")
        while self.queue or self._busy_count():
            if self.steps >= max_steps:
                if on_budget == "raise":
                    raise BudgetExceeded(self.pending)
                break
            if not self.step():
                raise RuntimeError("scheduler stalled: head request "
                                   "cannot be admitted")
        return self.finished

    def run_trace(self, arrivals: List[Tuple[int, Request]], *,
                  max_steps: int = 1_000_000) -> ServeReport:
        """Drive a timed arrival trace: ``arrivals`` is tick-sorted
        [(tick, Request)] (see ``serve.traffic.materialize``).  Requests
        are submitted when the scheduler clock reaches their tick; the
        clock fast-forwards over idle gaps (counted in ``idle_ticks``)."""
        i = 0
        while True:
            while i < len(arrivals) and arrivals[i][0] <= self.steps:
                self.submit(arrivals[i][1])
                i += 1
            if not self.queue and not self._busy_count():
                if i >= len(arrivals):
                    break
                self.idle_ticks += arrivals[i][0] - self.steps
                self.steps = arrivals[i][0]
                continue
            if self.steps >= max_steps:
                break
            self.step()
        return self.report()

    def report(self) -> ServeReport:
        lat = [self._finish[r] - self._arrive[r] for r in self.finished]
        ttft = [self._first_tok[r] - self._arrive[r] for r in self.finished
                if r in self._first_tok]
        occ = self._occupancy or [0]
        tokens = sum(len(r.generated) for r in self.finished.values())
        return ServeReport(
            ticks=self.steps,
            idle_ticks=self.idle_ticks,
            requests_finished=len(self.finished),
            requests_pending=len(self.pending),
            tokens=tokens,
            tokens_per_tick=tokens / max(self.steps, 1),
            p50_latency=float(np.percentile(lat, 50)) if lat else 0.0,
            p99_latency=float(np.percentile(lat, 99)) if lat else 0.0,
            p50_ttft=float(np.percentile(ttft, 50)) if ttft else 0.0,
            max_concurrency=max(occ),
            mean_occupancy=float(np.mean(occ)) / self.n_lanes,
            peak_blocks=self._peak_blocks,
            preemptions=self.preemptions,
        )

    # ------------------------------------------------------------ shared
    def _busy_count(self) -> int:
        return sum(r is not None for r in self.lane_req)

    def _inflight(self) -> List[Request]:
        lanes = [i for i in range(self.n_lanes)
                 if self.lane_req[i] is not None]
        return [self.lane_req[i]
                for i in sorted(lanes, key=lambda i: self._lane_order[i])]

    def _occupy(self, lane: int, req: Request) -> None:
        self.lane_req[lane] = req
        self._lane_order[lane] = self._admit_counter
        self._admit_seq.setdefault(req.rid, self._admit_counter)
        self._admit_counter += 1

    def _sample_lanes(self, logits_rows, reqs: List[Request]) -> np.ndarray:
        """Sample one token per row with each request's settings and its
        counter-based stream (seed, rid, n_generated)."""
        gens = [stream(self.seed, r.rid, len(r.generated), self.device)
                if r.temperature > 0 else None for r in reqs]
        toks = sample_batched(logits_rows, gens,
                              [r.temperature for r in reqs],
                              [r.top_k for r in reqs])
        return toks.cpu().numpy()

    def _record_token(self, req: Request, tok: int) -> None:
        if not req.generated:
            self._first_tok.setdefault(req.rid, self.steps)
        req.generated.append(tok)

    def _finish_lane(self, lane: int) -> None:
        req = self.lane_req[lane]
        self.finished[req.rid] = req
        self._finish[req.rid] = self.steps

    # ---------------------------------------------------------- abstract
    def _validate(self, req: Request) -> None:
        raise NotImplementedError

    def _tick(self) -> bool:
        raise NotImplementedError


class ContinuousBatcher(_BatcherBase):
    """Paged continuous batcher (see module docstring).

    ``n_slots`` is the lane count (decode batch width); ``cache_len``
    bounds a single request's prompt+generation length.  ``num_blocks``
    defaults to ``n_slots * ceil(cache_len / block_size)`` — the memory
    a dense batcher of that geometry preallocates — but the blocks are
    shared, so more than ``n_slots`` requests' worth of short sequences
    fit.  ``chunk_size=None`` prefills whole prompts in one chunk."""

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 4,
                 cache_len: int = 128, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 chunk_size: Optional[int] = None, seed: int = 0):
        super().__init__(params, cfg, n_slots, seed)
        self.cache_len = cache_len
        self.block_size = block_size
        self.nb_max = -(-cache_len // block_size)
        self.num_blocks = num_blocks or n_slots * self.nb_max
        self.chunk_size = chunk_size
        self.pool = BlockPool(self.num_blocks, block_size, n_slots,
                              self.nb_max)
        with torch.inference_mode():
            self.cache = models.init_paged_cache(
                cfg, n_slots, self.num_blocks, block_size,
                device=self.device)
        self._seq: List[Optional[List[int]]] = [None] * n_slots
        self._filled = np.zeros((n_slots,), np.int64)
        self._resume_tok: List[Optional[int]] = [None] * n_slots

    # ------------------------------------------------------------- hooks
    def _validate(self, req: Request) -> None:
        need = len(req.tokens) + req.max_new_tokens
        if need > self.cache_len:
            raise ValueError("request exceeds cache_len")
        if self.pool.blocks_for(need) > self.num_blocks:
            raise ValueError("request exceeds total block pool")

    def _tick(self) -> bool:
        worked = self._admit_and_prefill()
        worked |= self._decode()
        self._peak_blocks = max(self._peak_blocks, self.pool.used_blocks)
        return worked

    # --------------------------------------------------------- internals
    def _zero_lane_state(self, lane: int) -> None:
        """A new occupant starts from a zero Mamba state: the carried
        (conv, ssm) rows of the previous one must not leak into its
        chunked prefill.  Attention blocks need no reset: slots beyond a
        lane's write position are masked."""
        if "conv" in self.cache:
            self.cache["conv"][:, lane] = 0
            self.cache["ssm"][:, lane] = 0

    def _admit_and_prefill(self) -> bool:
        """FIFO head-of-line admission + at most one prefill chunk per
        lane occupant.  Lanes freed by a request finishing AT prefill
        are re-scanned within the same tick."""
        worked = False
        advanced = set()                      # (lane, rid) chunked this tick
        progress = True
        while progress:
            progress = False
            # admit the queue head while a lane + its prompt blocks fit
            while self.queue:
                free = [i for i in range(self.n_lanes)
                        if self.lane_req[i] is None]
                if not free:
                    break
                req = self.queue[0]
                lane = free[0]
                # resume keeps generated tokens: re-prefill all but the
                # last, which becomes the next token to decode
                seq = list(req.tokens) + req.generated[:-1]
                if not self.pool.ensure(lane, len(seq)):
                    break                     # head-of-line: wait, not skip
                self.queue.popleft()
                self._occupy(lane, req)
                self._zero_lane_state(lane)
                self._seq[lane] = seq
                self._filled[lane] = 0
                self._resume_tok[lane] = (req.generated[-1]
                                          if req.generated else None)
                worked = True
            # one chunk per prefilling occupant
            for lane in range(self.n_lanes):
                req = self.lane_req[lane]
                if req is None:
                    continue
                seq = self._seq[lane]
                if self._filled[lane] >= len(seq) \
                        or (lane, req.rid) in advanced:
                    continue
                advanced.add((lane, req.rid))
                lo = int(self._filled[lane])
                hi = min(lo + (self.chunk_size or len(seq)), len(seq))
                logits, self.cache = models.prefill_chunk_paged(
                    self.params, self.cache, [seq[lo:hi]], lo, self.cfg,
                    self.pool.tables[lane], lane,
                    block_size=self.block_size)
                self._filled[lane] = hi
                worked = True
                if hi < len(seq):
                    continue
                # prefill complete -> decode phase
                self.pos[lane] = len(seq)
                if self._resume_tok[lane] is not None:
                    self.last_token[lane] = self._resume_tok[lane]
                    self._resume_tok[lane] = None
                else:
                    tok = int(self._sample_lanes(logits, [req])[0])
                    self._record_token(req, tok)
                    self.last_token[lane] = tok
                    if req.done:
                        self._retire(lane)
                        progress = True       # re-scan the freed lane
        return worked

    def _decode(self) -> bool:
        decoding = [i for i in range(self.n_lanes)
                    if self.lane_req[i] is not None
                    and self._filled[i] >= len(self._seq[i])]
        if not decoding:
            return False
        # claim each lane's write block; preempt the youngest admission
        # if EVERY decode lane is stalled on the pool
        did_preempt = False
        while True:
            ready = [i for i in decoding
                     if self.pool.ensure(i, int(self.pos[i]) + 1)]
            if ready or not decoding:
                break
            victim = max(decoding, key=lambda i: self._lane_order[i])
            self._preempt(victim)
            did_preempt = True
            decoding.remove(victim)
        if not ready:
            return did_preempt
        active = np.zeros((self.n_lanes,), bool)
        active[ready] = True
        logits, self.cache = models.decode_step_paged(
            self.params, self.cache, self.last_token, self.pos, self.cfg,
            self.pool.tables, active, block_size=self.block_size)
        reqs = [self.lane_req[i] for i in ready]
        toks = self._sample_lanes(logits[ready], reqs)
        for j, i in enumerate(ready):
            req = self.lane_req[i]
            self._record_token(req, int(toks[j]))
            self.last_token[i] = toks[j]
            self.pos[i] += 1
            if req.done:
                self._retire(i)
        return True

    def _preempt(self, lane: int) -> None:
        req = self.lane_req[lane]
        self._free_lane(lane)
        self.queue.appendleft(req)            # resumes first, FIFO kept
        self.preemptions += 1

    def _retire(self, lane: int) -> None:
        self._finish_lane(lane)
        self._free_lane(lane)

    def _free_lane(self, lane: int) -> None:
        self.pool.release(lane)
        self.lane_req[lane] = None
        self._seq[lane] = None
        self._filled[lane] = 0
        self._resume_tok[lane] = None
        self.pos[lane] = 0
        self.last_token[lane] = 0


class DenseBatcher(_BatcherBase):
    """Fixed-slot batcher, the reference arm.

    One dense ``(L, n_slots, cache_len, ...)`` cache: every slot
    reserves worst-case memory for its request, so concurrency is
    pinned at ``n_slots`` no matter how short the requests are."""

    def __init__(self, params, cfg: ModelConfig, *, n_slots: int = 4,
                 cache_len: int = 128, seed: int = 0):
        super().__init__(params, cfg, n_slots, seed)
        self.cache_len = cache_len
        with torch.inference_mode():
            self.cache = models.init_cache(cfg, params, n_slots, cache_len)

    # ------------------------------------------------------------- hooks
    def _validate(self, req: Request) -> None:
        if len(req.tokens) + req.max_new_tokens > self.cache_len:
            raise ValueError("request exceeds cache_len")

    def _tick(self) -> bool:
        worked = self._admit()
        worked |= self._decode()
        return worked

    # --------------------------------------------------------- internals
    def _admit(self) -> bool:
        """Whole-prompt prefill into free slot rows; slots freed by a
        request finishing at prefill are re-scanned in the same tick."""
        worked = False
        progress = True
        while progress:
            progress = False
            for i in range(self.n_lanes):
                if self.lane_req[i] is not None or not self.queue:
                    continue
                req = self.queue.popleft()
                prompt = torch.as_tensor([req.tokens], dtype=torch.long,
                                         device=self.device)
                logits, pcache = models.prefill(
                    self.params, prompt, self.cfg, self.cache_len,
                    use_kernels=True, last_only=True)
                for name, big in self.cache.items():
                    big[:, i] = pcache[name][:, 0]      # in place
                self._occupy(i, req)
                self.pos[i] = len(req.tokens)
                tok = int(self._sample_lanes(logits[:, -1], [req])[0])
                self._record_token(req, tok)
                self.last_token[i] = tok
                worked = True
                if req.done:
                    self._retire(i)
                    progress = True
        return worked

    def _decode(self) -> bool:
        lanes = [i for i in range(self.n_lanes)
                 if self.lane_req[i] is not None]
        if not lanes:
            return False
        active = np.zeros((self.n_lanes,), bool)
        active[lanes] = True
        logits, self.cache = models.decode_step(
            self.params, self.cache, self.last_token, self.pos, self.cfg,
            active=active)
        reqs = [self.lane_req[i] for i in lanes]
        toks = self._sample_lanes(logits[lanes], reqs)
        for j, i in enumerate(lanes):
            req = self.lane_req[i]
            self._record_token(req, int(toks[j]))
            self.last_token[i] = toks[j]
            self.pos[i] += 1
            if req.done:
                self._retire(i)
        return True

    def _retire(self, i: int) -> None:
        self._finish_lane(i)
        self.lane_req[i] = None
        self.pos[i] = 0
        self.last_token[i] = 0
