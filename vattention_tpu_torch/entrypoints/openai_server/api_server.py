"""OpenAI-compatible HTTP server (aiohttp) over the port's AsyncLLMEngine.

Counterpart of ``vattention_tpu/entrypoints/openai_server/api_server.py``,
route for route: ``/health``, ``/v1/models``, ``/v1/completions`` and
``/v1/chat/completions``, the optional API-key middleware on ``/v1``,
prompts as text or token ids, SSE streaming with
``stream_options.include_usage``, ``n`` / ``best_of`` fan-out (each choice
is its own engine request), and ``logprobs`` / ``top_logprobs`` up to the
engine's ``max_logprobs``.  A server without a tokenizer answers in token
ids (a JSON list as the text) and refuses text prompts and chat.

Run (on the GPU; ``--device cpu`` runs it on the CPU):

    python -m vattention_tpu_torch.entrypoints.openai_server.api_server \\
        --model <local-hf-dir-or-registry-name> [--load-format safetensors] \\
        [--port 8000]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import time
from typing import Optional

from aiohttp import web

from vattention_tpu_torch.engine.async_llm_engine import AsyncLLMEngine
from vattention_tpu_torch.entrypoints.openai_server.protocol import (
    ChatCompletionRequest, CompletionRequest, chat_choice, chat_logprobs,
    chat_response, chat_stream_chunk, completion_choice,
    completion_logprobs, completion_response, completion_stream_chunk,
    error_response, random_id, usage_dict)
from vattention_tpu_torch.logger import init_logger

logger = init_logger(__name__)


class OpenAIServer:
    def __init__(self, engine: AsyncLLMEngine, served_model: str,
                 api_key: Optional[str] = None, max_logprobs: int = 0):
        self.engine = engine
        self.served_model = served_model
        self.api_key = api_key
        # top-N the ENGINE computes per token (requests may ask for less)
        self.max_logprobs = max_logprobs

    # ------------------------------------------------------------------ #
    def app(self) -> web.Application:
        app = web.Application(middlewares=[self._auth_middleware])
        app.router.add_get("/health", self.health)
        app.router.add_get("/v1/models", self.models)
        app.router.add_post("/v1/completions", self.completions)
        app.router.add_post("/v1/chat/completions", self.chat_completions)
        return app

    @web.middleware
    async def _auth_middleware(self, request, handler):
        if self.api_key and request.path.startswith("/v1"):
            auth = request.headers.get("Authorization", "")
            if auth != f"Bearer {self.api_key}":
                return web.json_response(
                    error_response("invalid api key", 401), status=401)
        return await handler(request)

    # ------------------------------------------------------------------ #
    async def health(self, request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def models(self, request) -> web.Response:
        return web.json_response({
            "object": "list",
            "data": [{"id": self.served_model, "object": "model",
                      "created": int(time.time()),
                      "owned_by": "vattention-tpu"}],
        })

    def _encode_prompt(self, prompt):
        tokenizer = self.engine.get_tokenizer()
        if isinstance(prompt, list):
            return None, prompt
        if tokenizer is None:
            raise ValueError(
                "server running tokenizer-less; pass prompt as token ids")
        return prompt, tokenizer.encode(prompt)

    def _id_to_str(self, token_id: int) -> str:
        tokenizer = self.engine.get_tokenizer()
        if tokenizer is None:
            return str(token_id)
        try:
            return tokenizer.decode([token_id])
        except Exception:  # noqa: BLE001
            return str(token_id)

    def _check_logprobs(self, n_top: Optional[int]):
        if n_top and n_top > max(self.max_logprobs, 0):
            raise ValueError(
                f"logprobs={n_top} exceeds this server's "
                f"--max-logprobs {self.max_logprobs}")

    def _spawn(self, prefix: str, prompt, token_ids, params, k: int):
        """k engine requests for one API request (n / best_of fan-out;
        each choice samples independently inside the batched step)."""
        return [self.engine.generate(prompt, params,
                                     request_id=random_id(prefix),
                                     prompt_token_ids=token_ids)
                for _ in range(k)]

    @staticmethod
    async def _merge_streams(gens):
        """Interleave k request generators into (choice_idx, out) pairs."""
        queue: asyncio.Queue = asyncio.Queue()

        async def pump(i, gen):
            try:
                async for out in gen:
                    await queue.put((i, out, None))
            except Exception as e:  # noqa: BLE001
                await queue.put((i, None, e))
                return
            await queue.put((i, None, None))

        tasks = [asyncio.create_task(pump(i, g))
                 for i, g in enumerate(gens)]
        done = 0
        try:
            while done < len(gens):
                i, out, err = await queue.get()
                if err is not None:
                    raise err
                if out is None:
                    done += 1
                    continue
                yield i, out
        finally:
            for t in tasks:
                t.cancel()

    @staticmethod
    async def _collect(gens):
        """Each request's final output (raises what the engine refused a
        request for, e.g. a prompt past max_model_len)."""
        async def last(gen):
            final = None
            async for out in gen:
                final = out
            return final

        return await asyncio.gather(*[last(g) for g in gens])

    def _slice_logprobs(self, out, start: int, n_top: int, chat: bool):
        """Wire-format logprobs for out's tokens [start:] (streaming
        deltas pass the already-sent count)."""
        if out.logprobs is None:
            return None, len(out.token_ids)
        lps = out.logprobs[start:]
        strs = [self._id_to_str(t) for t in out.token_ids[start:]]
        fmt = chat_logprobs if chat else completion_logprobs
        return (fmt(strs, lps, n_top or 0, self._id_to_str),
                len(out.token_ids))

    async def _stream(self, request, request_id: str, gens, stream_options,
                      n_top: Optional[int], chat: bool) -> web.StreamResponse:
        """Server-sent events: one chunk per output of any choice, then
        the usage chunk if asked for, then ``[DONE]``."""
        chunk_fn = chat_stream_chunk if chat else completion_stream_chunk
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream"})
        await resp.prepare(request)
        k = len(gens)
        sent = [0] * k
        lp_sent = [0] * k
        finals = [None] * k
        async for i, out in self._merge_streams(gens):
            delta = out.text[sent[i]:]
            sent[i] = len(out.text)
            finals[i] = out
            lp_fmt = None
            if n_top is not None:
                lp_fmt, lp_sent[i] = self._slice_logprobs(
                    out, lp_sent[i], n_top, chat)
            chunk = chunk_fn(request_id, self.served_model, delta,
                             out.finish_reason if out.finished else None,
                             index=i, logprobs=lp_fmt)
            await resp.write(f"data: {json.dumps(chunk)}\n\n".encode())
        if (stream_options or {}).get("include_usage") and finals[0]:
            live = [f for f in finals if f]
            usage = usage_dict(len(live[0].prompt_token_ids),
                               sum(len(f.token_ids) for f in live))
            final_chunk = chunk_fn(request_id, self.served_model, "", None,
                                   usage=usage)
            final_chunk["choices"] = []
            await resp.write(f"data: {json.dumps(final_chunk)}\n\n".encode())
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    def _choices(self, finals, n_top: Optional[int], chat: bool):
        choice_fn = chat_choice if chat else completion_choice
        choices = []
        for i, final in enumerate(finals):
            text = (final.text if final.text
                    else json.dumps(final.token_ids))
            lp_fmt = None
            if n_top is not None:
                lp_fmt, _ = self._slice_logprobs(final, 0, n_top, chat)
            choices.append(choice_fn(i, text, final.finish_reason, lp_fmt))
        return choices

    # ------------------------------------------------------------------ #
    async def completions(self, request) -> web.StreamResponse:
        try:
            body = CompletionRequest.from_dict(await request.json())
            self._check_logprobs(body.logprobs)
            prompt, token_ids = self._encode_prompt(body.prompt)
        except Exception as e:  # noqa: BLE001
            return web.json_response(error_response(str(e)), status=400)
        request_id = random_id("cmpl")
        k = body.best_of or body.n
        gens = self._spawn("cmpl-req", prompt, token_ids,
                           body.to_sampling_params(), k)
        if body.stream:
            return await self._stream(request, request_id, gens,
                                      body.stream_options, body.logprobs,
                                      chat=False)
        try:
            all_finals = await self._collect(gens)
        except ValueError as e:
            return web.json_response(error_response(str(e)), status=400)
        # best_of: keep the n highest-cumulative-logprob candidates;
        # usage still counts every sampled candidate (OpenAI semantics)
        finals = all_finals
        if k > body.n:
            finals = sorted(finals, key=lambda f: -f.cumulative_logprob
                            )[:body.n]
        return web.json_response(completion_response(
            request_id, self.served_model,
            self._choices(finals, body.logprobs, chat=False),
            len(all_finals[0].prompt_token_ids),
            sum(len(f.token_ids) for f in all_finals)))

    # ------------------------------------------------------------------ #
    def _apply_chat_template(self, messages) -> str:
        tokenizer = self.engine.get_tokenizer()
        if tokenizer is not None and getattr(
                tokenizer, "chat_template", None):
            return tokenizer.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        # minimal fallback template
        parts = [f"{m['role']}: {m['content']}" for m in messages]
        parts.append("assistant:")
        return "\n".join(parts)

    async def chat_completions(self, request) -> web.StreamResponse:
        try:
            body = ChatCompletionRequest.from_dict(await request.json())
            self._check_logprobs(
                body.top_logprobs if body.logprobs else None)
            prompt = self._apply_chat_template(body.messages)
            _, token_ids = self._encode_prompt(prompt)
        except Exception as e:  # noqa: BLE001
            return web.json_response(error_response(str(e)), status=400)
        request_id = random_id("chatcmpl")
        gens = self._spawn("chat-req", prompt, token_ids,
                           body.to_sampling_params(), body.n)
        # logprobs=true without top_logprobs: the tokens' own logprobs
        n_top = (body.top_logprobs or 0) if body.logprobs else None
        if body.stream:
            return await self._stream(request, request_id, gens,
                                      body.stream_options, n_top, chat=True)
        try:
            finals = await self._collect(gens)
        except ValueError as e:
            return web.json_response(error_response(str(e)), status=400)
        return web.json_response(chat_response(
            request_id, self.served_model,
            self._choices(finals, n_top, chat=True),
            sum(len(f.prompt_token_ids) for f in finals),
            sum(len(f.token_ids) for f in finals)))


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--api-key", default=None)
    p.add_argument("--model", default="tiny-llama-debug")
    p.add_argument("--attention-backend", default="fa_vattn")
    p.add_argument("--scheduler-type", default="sarathi")
    p.add_argument("--max-model-len", type=int, default=None)
    p.add_argument("--max-batch-size", type=int, default=32)
    p.add_argument("--chunk-size", type=int, default=512)
    p.add_argument("--load-format", default="dummy",
                   help="dummy, zero, or safetensors (--model is then a "
                        "local HF checkpoint directory)")
    p.add_argument("--max-logprobs", type=int, default=5,
                   help="top-N alternative logprobs the engine computes "
                        "per token (requests may ask for at most this)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args()

    engine = AsyncLLMEngine.from_engine_args(
        model=args.model, attention_backend=args.attention_backend,
        scheduler_type=args.scheduler_type,
        max_model_len=args.max_model_len,
        max_batch_size=args.max_batch_size,
        max_num_seqs=args.max_batch_size,
        chunk_size=args.chunk_size, load_format=args.load_format,
        max_logprobs=args.max_logprobs, device=args.device)
    server = OpenAIServer(engine, args.model, args.api_key,
                          max_logprobs=args.max_logprobs)
    logger.info("serving %s on http://%s:%d (%s)", args.model, args.host,
                args.port, engine.engine.device)
    try:
        web.run_app(server.app(), host=args.host, port=args.port,
                    print=None)
    finally:
        engine.shutdown()


if __name__ == "__main__":
    main()
