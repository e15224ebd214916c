"""Drive the port's OpenAI server over HTTP, as its users do.

``drive(server, requests)`` starts an ``OpenAIServer`` on 127.0.0.1 at an
ephemeral port, sends every request at once from one aiohttp client
session, and returns, per request: the generated token ids (parsed from
the text of a server whose tokenizer is ``checkpoint.write_word_tokenizer``'s,
or the JSON list of a tokenizer-less one), the finish reason, the usage,
the logprobs, the seconds to its first token (streamed requests: the
first chunk that carries one) and to its end.  chip_smoke's phase (s)
serves yi-6b width through it on the card; the tests run it on the CPU.
"""

from __future__ import annotations

import asyncio
import json
import time
from typing import Dict, List

from vattention_tpu_torch.microbenchmarks.checkpoint import parse_words


def _tokens(text: str) -> List[int]:
    text = text.strip()
    return json.loads(text) if text.startswith("[") else parse_words(text)


async def _one(session, base: str, req: dict) -> dict:
    path = req.get("path", "/v1/completions")
    body = req["body"]
    chat = path.endswith("/chat/completions")
    t0 = time.perf_counter()
    out = {"id": req["id"], "first_s": None, "logprobs": None}
    async with session.post(base + path, json=body) as r:
        if r.status != 200:
            raise RuntimeError(f"{req['id']}: HTTP {r.status}: "
                               f"{await r.text()}")
        if not body.get("stream"):
            data = await r.json()
            choice = data["choices"][0]
            text = choice["message"]["content"] if chat else choice["text"]
            out.update(tokens=_tokens(text),
                       finish_reason=choice["finish_reason"],
                       usage=data["usage"], logprobs=choice["logprobs"])
            out["first_s"] = out["done_s"] = time.perf_counter() - t0
            return out
        text, lps, finish = "", [], None
        async for line in r.content:
            line = line.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            choice = json.loads(line[len("data: "):])["choices"][0]
            delta = (choice["delta"].get("content", "") if chat
                     else choice["text"])
            if delta and out["first_s"] is None:
                out["first_s"] = time.perf_counter() - t0
            text += delta
            if choice["logprobs"] is not None:
                lps += choice["logprobs"]["token_logprobs"]
            finish = choice["finish_reason"] or finish
        out.update(tokens=_tokens(text), finish_reason=finish, usage=None,
                   done_s=time.perf_counter() - t0)
        if lps:
            out["logprobs"] = {"token_logprobs": lps}
        return out


async def _drive(server, requests: List[dict]) -> Dict[str, dict]:
    import aiohttp
    from aiohttp import web

    runner = web.AppRunner(server.app())
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = runner.addresses[0][1]
    try:
        async with aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=900)) as session:
            base = f"http://127.0.0.1:{port}"
            async with session.get(base + "/health") as r:
                if r.status != 200:
                    raise RuntimeError(f"/health: HTTP {r.status}")
            outs = await asyncio.gather(*[_one(session, base, q)
                                          for q in requests])
    finally:
        await runner.cleanup()
    return {o["id"]: o for o in outs}


def drive(server, requests: List[dict]) -> Dict[str, dict]:
    """requests: [{"id", "body", "path" (default /v1/completions)}] ->
    {id: {"tokens", "finish_reason", "usage", "logprobs", "first_s",
    "done_s"}}, all sent at once in a new event loop."""
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(_drive(server, requests))
    finally:
        loop.run_until_complete(server.engine.stop_background_loop())
        loop.close()
