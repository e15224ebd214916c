"""Plays a cell's clients against the port's engine and stamps what they see.

The engine is ``vattention_tpu_torch``'s ``LLMEngine``, built from the
configuration's and the cell's engine settings with ``load_format="zero"``;
the seed's weights are then copied into its parameters in place
(``weights.load_into_program``) before any step runs, so no graph is
captured on other weights.  The warm-up serves one 32-token request of 3
greedy tokens, which meets both step signatures a sarathi engine with one
prefill width has (a step with a prompt chunk, a decode-only step): each
is run eagerly once and captured, so nothing compiles or captures inside
the window.

The clients call ``add_request`` when a request is due and ``step()`` in
a loop, and stamp each output token on the host's monotonic clock when
``step()`` hands it back.  A closed-loop client sends its next request
when the last one finishes; open-loop requests are sent at their due
times, and the host sleeps only when the engine has nothing to do.

The window opens after ``torch.cuda.synchronize()``, so no step of the
set-up runs inside it, and closes when the clients stop dispatching and
the device has finished what they dispatched.  Every step the engine
dispatches is recorded from the scheduler's output the worker receives
(``counts.Step``: each prompt chunk's length and the keys before it, each
decoding sequence's length), so the work of the window is counted from
its shapes.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

from port_bench import counts, weights
from port_bench.generator import Request, Traffic

WARMUP_PROMPT = list(range(1, 33))
WARMUP_TOKENS = 3

# ModelArch field -> the published config's key
ARCH_KEYS = {
    "num_layers": "num_hidden_layers", "num_q_heads": "num_attention_heads",
    "num_kv_heads": "num_key_value_heads", "head_dim": "head_dim",
    "hidden_size": "hidden_size", "intermediate_size": "intermediate_size",
    "vocab_size": "vocab_size",
    "max_position_embeddings": "max_position_embeddings",
    "rope_theta": "rope_theta", "rms_norm_eps": "rms_norm_eps",
    "sliding_window": "sliding_window",
    "tie_word_embeddings": "tie_word_embeddings",
}


@dataclass
class Record:
    """One request as its client saw it."""
    req: Request
    due: float                      # host clock when it was due
    stamps: List[float] = field(default_factory=list)  # each token's arrival
    finished_at: Optional[float] = None
    tokens: Optional[List[int]] = None     # the served tokens, once finished
    logprobs: Optional[List[float]] = None
    scheduling_delay: Optional[float] = None
    slot: Optional[int] = None      # its decode row (batch slot)


def check_arch(config: dict, arch) -> None:
    """The port's registry entry must hold the configuration file's sizes:
    the file is the configuration as it is run."""
    wrong = []
    for field_name, key in ARCH_KEYS.items():
        want = config.get(key)
        have = getattr(arch, field_name)
        if key == "sliding_window" or key == "tie_word_embeddings":
            want = want or None
            have = have or None
        if want != have:
            wrong.append(f"{key}: file {want!r}, port {have!r}")
    if wrong:
        raise ValueError(f"{config['name']}: the port's {config['port_model']!r}"
                         f" differs from the configuration: {'; '.join(wrong)}")


def build_engine(cell, device: str, seed: int, *, kv_quant: Optional[str]):
    """The engine with the seed's weights in place, warmed up."""
    from vattention_tpu_torch.engine.llm_engine import LLMEngine
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    MetricsStore._instance = None
    kw = cell.engine_kwargs
    if kv_quant is not None:
        kw["kv_quant"] = kv_quant
    kw.update(model=cell.config["port_model"], load_format="zero",
              device=device, seed=seed)
    engine = LLMEngine.from_engine_args(**kw)
    check_arch(cell.config, engine.config.model_config.arch)
    weights.load_into_program(cell, engine.worker.model_runner.params, seed)
    warm_up(engine)
    return engine


def warm_up(engine) -> None:
    from vattention_tpu_torch.core.datatypes.sampling_params import (
        SamplingParams)

    engine.add_request(None, SamplingParams(
        temperature=0.0, ignore_eos=True, max_tokens=WARMUP_TOKENS),
        prompt_token_ids=WARMUP_PROMPT, seq_id="warmup")
    while engine.has_unfinished_requests():
        engine.step()
    engine.reset_metrics()


def free_engine(engine) -> None:
    from vattention_tpu_torch.metrics.metrics_store import MetricsStore

    engine.cleanup()
    engine.worker.cache_engine = None
    MetricsStore._instance = None


class Clients:
    """The cell's clients, one engine, the records of what they saw."""

    def __init__(self, engine, traffic: Traffic, vocab: int, device: str,
                 span: Callable = None):
        self.engine = engine
        self.traffic = traffic
        self.vocab = vocab
        self.device = device
        self.span = span or (lambda name: contextlib.nullcontext())
        self.records: Dict[str, Record] = {}
        self.steps: List[counts.Step] = []
        self.pending: List[Request] = []   # open loop: not yet sent
        self.closed = traffic.closed
        self.accepting = True              # closed loop: clients send more
        self.t_open = self.t_close = None
        self._first: List[Request] = []    # closed loop: sent at the open
        self._later: List[Request] = []    # open loop: due in the window
        self._record_dispatches()

    # ------------------------------------------------------------------ #
    def _record_dispatches(self) -> None:
        """Wrap the worker's dispatch to keep each step's shapes, the K/V
        the live sequences hold after it, and each request's batch slot
        (the decode row the kernels give it, fixed for its life)."""
        worker = self.engine.worker
        dispatch = worker.execute_model_async

        def recorded(scheduler_outputs, metas, *args, **kwargs):
            step = counts.Step(t=time.monotonic())
            chunk = {}
            for m in metas:
                seq = m.seq
                if m.is_prompt:
                    done = seq.get_num_prompt_tokens_processed()
                    step.chunks.append((m.prompt_chunk_len, done))
                    chunk[m.seq_id] = done + m.prompt_chunk_len
                    if done + m.prompt_chunk_len == seq.get_prompt_len():
                        step.sampled += 1
                else:
                    step.decodes.append(seq.get_len())
                    step.sampled += 1
            step.held = sum(
                chunk[s.seq_id] if s.seq_id in chunk
                else s.get_len() if s.prompt_processing_finished
                else s.get_num_prompt_tokens_processed()
                for s in self.engine.scheduler.running)
            self.steps.append(step)
            out = dispatch(scheduler_outputs, metas, *args, **kwargs)
            self._note_slots(metas)
            return out

        worker.execute_model_async = recorded

    def _note_slots(self, metas) -> None:
        cache_engine = self.engine.worker.cache_engine
        for m in metas:
            rec = self.records.get(m.seq_id)
            if rec is not None and rec.slot is None:
                rec.slot = int(cache_engine.slot_of(m.seq_id))

    def sync(self) -> None:
        if self.device != "cpu":
            torch.cuda.synchronize()

    # ------------------------------------------------------------------ #
    def send(self, req: Request, due: float) -> None:
        from vattention_tpu_torch.core.datatypes.sampling_params import (
            SamplingParams)

        with self.span("admit"):
            ids = self.traffic.token_ids(req, self.vocab)
            seq_id = f"r{req.rid}"
            self.records[seq_id] = Record(req, due)
            self.engine.add_request(
                None, SamplingParams(temperature=0.0, ignore_eos=True,
                                     max_tokens=req.max_tokens),
                prompt_token_ids=ids, arrival_time=due, seq_id=seq_id)

    def _take(self, outputs, now: float) -> None:
        for out in outputs:
            rec = self.records.get(out.seq_id)
            if rec is None:
                continue
            n = len(out.token_ids)
            if n > len(rec.stamps):
                rec.stamps.extend([now] * (n - len(rec.stamps)))
            if out.finished and rec.finished_at is None:
                rec.finished_at = now
                rec.tokens = list(out.token_ids)
                rec.logprobs = [lp[0] for lp in out.logprobs]
                seq = self.engine.seq_manager.seq_map.get(out.seq_id)
                if seq is not None:
                    rec.scheduling_delay = seq.state.scheduling_delay
                if self.closed and self.accepting:
                    self.send(self.traffic.next_request(rec.req.client), now)

    def step(self) -> None:
        with self.span("step"):
            outputs = self.engine.step()
        self._take(outputs, time.monotonic())

    def drive(self, until: float, stop: Callable[[], bool] = None) -> None:
        """Serve until the host clock reads ``until`` or ``stop()``."""
        while True:
            now = time.monotonic()
            if now >= until or (stop is not None and stop()):
                return
            while self.pending and self.pending[0].due <= now:
                req = self.pending.pop(0)
                self.send(req, req.due)
            if self.engine.has_unfinished_requests():
                self.step()
                continue
            wake = min(until, self.pending[0].due) if self.pending else until
            if not self.pending and stop is not None:
                return   # nothing left to serve
            with self.span("wait"):
                time.sleep(max(0.0, wake - time.monotonic()))

    # ------------------------------------------------------------------ #
    def ramp(self, seconds: float) -> None:
        """Set-up that the traffic needs before the window: a closed
        loop's first requests (each until its first token where they
        start partway through, else sent as the window opens), an open
        loop's arrivals due before it."""
        now = time.monotonic()
        if self.closed:
            first = self.traffic.first_requests()
            if not self.traffic.params.get("residual_start"):
                self._first = first
                return
            for req in first:
                self.send(req, now)
            ids = [f"r{r.rid}" for r in first]
            self.drive(float("inf"), stop=lambda: all(
                self.records[i].stamps for i in ids))
            return
        open_at = now + float(self.traffic.params.get("ramp_s", 0.0))
        reqs = self.traffic.arrivals(seconds)
        ramp = [r for r in reqs if r.due < 0]
        for r in ramp:
            r.due = open_at + r.due
        self.pending = sorted(ramp, key=lambda r: r.due)
        # the window's arrivals are due from the moment it opens
        self._later = [r for r in reqs if r.due >= 0]
        self.drive(open_at)

    def window(self, seconds: float, span=None) -> None:
        """The measured window: ``seconds`` of serving between two
        synchronizations (``span``, a context, marks it in a trace)."""
        self.sync()
        with span or contextlib.nullcontext():
            self.t_open = time.monotonic()
            for req in self._first:
                self.send(req, self.t_open)
            for req in self._later:
                req.due += self.t_open
            self.pending = sorted(self.pending + self._later,
                                  key=lambda r: r.due)
            self._first = self._later = []
            self.drive(self.t_open + seconds)
            self.sync()
            self.t_close = time.monotonic()
        self.accepting = False

    def note_delays(self) -> None:
        """Each request's scheduling delay as the engine has it at the
        close (None for one not yet scheduled)."""
        seqs = self.engine.seq_manager.seq_map
        for seq_id, rec in self.records.items():
            if rec.scheduling_delay is None and seq_id in seqs:
                rec.scheduling_delay = seqs[seq_id].state.scheduling_delay

    def drain(self, limit_s: float) -> None:
        """Serve what is in flight to its end (no new requests), for the
        comparison; nothing of it is timed."""
        self.pending = []
        self.drive(time.monotonic() + limit_s,
                   stop=lambda: not self.engine.has_unfinished_requests())
        self.sync()

    # ------------------------------------------------------------------ #
    def window_steps(self) -> List[counts.Step]:
        return [s for s in self.steps if self.t_open <= s.t < self.t_close]
