"""AsyncLLMEngine: the asyncio wrapper for online serving.

Counterpart of ``vattention_tpu/engine/async_llm_engine.py``: a
``RequestTracker`` of per-request ``AsyncStream``s and a background loop
that steps the engine off the event loop, so the loop keeps serving HTTP
while a step runs.

Unlike the JAX package, which steps in the event loop's default thread
pool, every call into the engine (adding requests and stepping) runs on
one dedicated thread, under the engine's device and the stream it was
built on: the step replays CUDA graphs, hands each kernel the current
stream (a per-thread setting) and reuses pinned staging buffers across the
steps in flight, so it must not move from thread to thread.  The engine is
async by default (``engine.step`` returns the outputs of older steps whose
samples have landed); the loop goes on stepping while
``has_unfinished_requests`` counts steps in flight, so a request's last
tokens are delivered before the loop waits for new requests.
"""

from __future__ import annotations

import asyncio
import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import AsyncIterator, Dict, List, Optional, Tuple

import torch

from vattention_tpu_torch.core.datatypes.request_output import RequestOutput
from vattention_tpu_torch.core.datatypes.sampling_params import SamplingParams
from vattention_tpu_torch.engine.base_llm_engine import BaseLLMEngine
from vattention_tpu_torch.engine.llm_engine import LLMEngine
from vattention_tpu_torch.logger import init_logger
from vattention_tpu_torch.utils.counter import Counter

logger = init_logger(__name__)


class AsyncStream:
    """One request's stream of outputs."""

    def __init__(self, seq_id: str):
        self.seq_id = seq_id
        self._queue: asyncio.Queue = asyncio.Queue()
        self._finished = False

    def put(self, item) -> None:
        if self._finished:
            return
        self._queue.put_nowait(item)

    def finish(self) -> None:
        self._finished = True
        self._queue.put_nowait(StopAsyncIteration())

    @property
    def finished(self) -> bool:
        return self._finished

    def __aiter__(self):
        return self

    async def __anext__(self) -> RequestOutput:
        item = await self._queue.get()
        if isinstance(item, StopAsyncIteration):
            raise StopAsyncIteration
        if isinstance(item, Exception):
            raise item
        return item


class RequestTracker:
    """The streams of live requests and the queue of new ones."""

    def __init__(self):
        self._streams: Dict[str, AsyncStream] = {}
        self._new_requests: asyncio.Queue = asyncio.Queue()
        self.new_requests_event: Optional[asyncio.Event] = None

    def init_event(self):
        self.new_requests_event = asyncio.Event()

    def add_request(self, stream_id: str, **engine_add_request_kwargs
                    ) -> AsyncStream:
        stream = AsyncStream(stream_id)
        self._streams[stream_id] = stream
        self._new_requests.put_nowait((stream, engine_add_request_kwargs))
        if self.new_requests_event is not None:
            self.new_requests_event.set()
        return stream

    def get_new_requests(self) -> List[dict]:
        out = []
        while not self._new_requests.empty():
            _, kwargs = self._new_requests.get_nowait()
            out.append(kwargs)
        return out

    def process_request_output(self, output: RequestOutput) -> None:
        stream = self._streams.get(output.seq_id)
        if stream is None:
            return
        stream.put(output)
        if output.finished:
            stream.finish()
            del self._streams[output.seq_id]

    def abort_request(self, seq_id: str,
                      exc: Optional[Exception] = None) -> None:
        """End a request's stream, raising ``exc`` in its reader if given."""
        stream = self._streams.pop(seq_id, None)
        if stream is not None:
            if exc is not None:
                stream.put(exc)
            stream.finish()

    def propagate_exception(self, exc: Exception) -> None:
        """End every live stream with ``exc`` (the engine loop failed)."""
        for stream in self._streams.values():
            stream.put(exc)
            stream.finish()
        self._streams.clear()


class AsyncLLMEngine:
    def __init__(self, engine: BaseLLMEngine):
        self.engine = engine
        self.tracker = RequestTracker()
        self.seq_counter = Counter()
        self._background_task: Optional[asyncio.Task] = None
        self._executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="vattn-engine")
        device = engine.device
        self._stream = (torch.cuda.current_stream(device)
                        if device.type == "cuda" else None)

    @classmethod
    def from_engine_args(cls, **kwargs) -> "AsyncLLMEngine":
        """Build an engine from EngineArgs fields; it runs on the GPU
        unless ``device="cpu"`` is passed."""
        return cls(LLMEngine.from_engine_args(**kwargs))

    def start_background_loop(self) -> None:
        self.tracker.init_event()
        self._background_task = asyncio.get_event_loop().create_task(
            self.run_engine_loop())

    def _ensure_background_loop(self) -> None:
        """(Re)start the engine loop if it never ran, ended, or belongs to
        another (closed) event loop."""
        task = self._background_task
        try:
            stale = (task is None or task.done()
                     or task.get_loop() is not asyncio.get_event_loop())
        except RuntimeError:
            stale = True
        if stale:
            self.start_background_loop()

    def _on_engine_thread(self):
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.engine.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    def _step(self, new_requests: List[dict]
              ) -> Tuple[List[RequestOutput], list, bool]:
        """On the engine's thread: admit ``new_requests``, run one step if
        there is work.  Returns the step's outputs, the requests the engine
        refused as (seq_id, error), and whether work (requests or steps in
        flight) remains."""
        refused = []
        with self._on_engine_thread():
            for kwargs in new_requests:
                try:
                    self.engine.add_request(**kwargs)
                except ValueError as e:  # e.g. a prompt past max_model_len
                    refused.append((kwargs["seq_id"], e))
            outputs = (self.engine.step()
                       if self.engine.has_unfinished_requests() else [])
            return outputs, refused, self.engine.has_unfinished_requests()

    async def run_engine_loop(self) -> None:
        loop = asyncio.get_running_loop()
        tracker = self.tracker
        while True:
            # cleared before the queue is read: a request that arrives
            # while the step runs sets it again, so the wait below returns
            tracker.new_requests_event.clear()
            new_requests = tracker.get_new_requests()
            try:
                outputs, refused, busy = await loop.run_in_executor(
                    self._executor, self._step, new_requests)
            except Exception as e:  # noqa: BLE001 -- ends every stream
                logger.exception("engine step failed")
                tracker.propagate_exception(e)
                raise
            for seq_id, e in refused:
                tracker.abort_request(seq_id, e)
            for output in outputs:
                tracker.process_request_output(output)
            if not busy:
                await tracker.new_requests_event.wait()
            await asyncio.sleep(0)

    async def generate(
        self,
        prompt: Optional[str],
        sampling_params: SamplingParams,
        request_id: Optional[str] = None,
        prompt_token_ids: Optional[List[int]] = None,
    ) -> AsyncIterator[RequestOutput]:
        self._ensure_background_loop()
        seq_id = request_id or str(next(self.seq_counter))
        stream = self.tracker.add_request(
            seq_id,
            prompt=prompt,
            sampling_params=sampling_params,
            prompt_token_ids=prompt_token_ids,
            arrival_time=time.monotonic(),
            seq_id=seq_id,
        )
        async for output in stream:
            yield output

    async def abort(self, request_id: str) -> None:
        self.tracker.abort_request(request_id)

    def get_tokenizer(self):
        return self.engine.tokenizer

    async def stop_background_loop(self) -> None:
        """End the background loop before its event loop closes (a step
        running on the engine's thread runs to its end there)."""
        task, self._background_task = self._background_task, None
        if task is not None and not task.done():
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task

    def shutdown(self) -> None:
        """Stop the background loop, wait for the engine's thread and free
        the engine's device memory."""
        if self._background_task is not None:
            self._background_task.cancel()
            self._background_task = None
        self._executor.shutdown(wait=True)
        self.engine.cleanup()
