"""OpenAI API protocol datatypes.

Counterpart of ``vattention_tpu/entrypoints/openai_server/protocol.py``,
field for field: plain dataclasses whose validation is explicit in
``from_dict``, and the wire shapes of responses, stream chunks and
logprobs.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

from vattention_tpu_torch.core.datatypes.sampling_params import SamplingParams


def random_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


@dataclass
class CompletionRequest:
    model: str
    prompt: Union[str, List[int]]
    max_tokens: int = 16
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    n: int = 1
    best_of: Optional[int] = None
    logprobs: Optional[int] = None
    stream: bool = False
    stream_options: Optional[Dict[str, Any]] = None
    stop: Optional[Union[str, List[str]]] = None
    ignore_eos: bool = False

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CompletionRequest":
        if "prompt" not in d:
            raise ValueError("missing required field: prompt")
        allowed = {f for f in cls.__dataclass_fields__}
        req = cls(**{k: v for k, v in d.items() if k in allowed})
        req.validate()
        return req

    def validate(self):
        if self.n < 1:
            raise ValueError("n must be >= 1")
        if self.best_of is not None and self.best_of < self.n:
            raise ValueError("best_of must be >= n")
        if self.logprobs is not None and self.logprobs < 0:
            raise ValueError("logprobs must be >= 0")
        if self.best_of is not None and self.best_of > self.n \
                and self.stream:
            raise ValueError("best_of > n is not supported with stream")

    def to_sampling_params(self):
        return SamplingParams(
            temperature=self.temperature, top_p=self.top_p,
            top_k=self.top_k, stop=self.stop, ignore_eos=self.ignore_eos,
            max_tokens=self.max_tokens)


@dataclass
class ChatMessage:
    role: str
    content: str


@dataclass
class ChatCompletionRequest:
    model: str
    messages: List[Dict[str, str]]
    max_tokens: int = 256
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = -1
    n: int = 1
    logprobs: bool = False
    top_logprobs: Optional[int] = None
    stream: bool = False
    stream_options: Optional[Dict[str, Any]] = None
    stop: Optional[Union[str, List[str]]] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ChatCompletionRequest":
        if "messages" not in d:
            raise ValueError("missing required field: messages")
        allowed = {f for f in cls.__dataclass_fields__}
        req = cls(**{k: v for k, v in d.items() if k in allowed})
        if req.n < 1:
            raise ValueError("n must be >= 1")
        if req.top_logprobs is not None and not req.logprobs:
            raise ValueError("top_logprobs requires logprobs=true")
        return req

    def to_sampling_params(self):
        return SamplingParams(
            temperature=self.temperature, top_p=self.top_p,
            top_k=self.top_k, stop=self.stop, max_tokens=self.max_tokens)


# --------------------------------------------------------------------- #
# logprobs formatting (OpenAI wire shapes)

def completion_logprobs(token_strs: List[str], lps: List,
                        n_top: int, id_to_str) -> dict:
    """Legacy completions shape: parallel arrays + per-position top
    dicts.  `lps` holds RequestOutput.logprobs entries
    ((logprob, [(tok_id, lp), ...]) or None)."""
    out = {"tokens": [], "token_logprobs": [], "top_logprobs": [],
           "text_offset": []}
    off = 0
    for s, entry in zip(token_strs, lps):
        out["tokens"].append(s)
        out["text_offset"].append(off)
        off += len(s)
        if entry is None:
            out["token_logprobs"].append(None)
            out["top_logprobs"].append(None)
            continue
        lp, top = entry
        out["token_logprobs"].append(lp)
        out["top_logprobs"].append(
            {id_to_str(i): p for i, p in (top or [])[:n_top]}
            if n_top else None)
    return out


def chat_logprobs(token_strs: List[str], lps: List,
                  n_top: int, id_to_str) -> dict:
    """Chat shape: {"content": [{token, logprob, top_logprobs: [...]}]}"""
    content = []
    for s, entry in zip(token_strs, lps):
        lp, top = entry if entry is not None else (None, None)
        content.append({
            "token": s,
            "logprob": lp,
            "bytes": list(s.encode("utf-8", errors="replace")),
            "top_logprobs": [
                {"token": id_to_str(i), "logprob": p,
                 "bytes": list(id_to_str(i).encode(
                     "utf-8", errors="replace"))}
                for i, p in (top or [])[:n_top]] if n_top else [],
        })
    return {"content": content}


def usage_dict(prompt_tokens: int, completion_tokens: int) -> dict:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def completion_response(request_id: str, model: str,
                        choices: List[dict],
                        prompt_tokens: int,
                        completion_tokens: int) -> dict:
    return {
        "id": request_id,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": usage_dict(prompt_tokens, completion_tokens),
    }


def completion_choice(index: int, text: str,
                      finish_reason: Optional[str],
                      logprobs: Optional[dict] = None) -> dict:
    return {"index": index, "text": text, "logprobs": logprobs,
            "finish_reason": finish_reason}


def completion_stream_chunk(request_id: str, model: str, text: str,
                            finish_reason: Optional[str],
                            index: int = 0,
                            logprobs: Optional[dict] = None,
                            usage: Optional[dict] = None) -> dict:
    chunk = {
        "id": request_id,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": [completion_choice(index, text, finish_reason,
                                      logprobs)],
    }
    if usage is not None:
        chunk["usage"] = usage
    return chunk


def chat_response(request_id: str, model: str, choices: List[dict],
                  prompt_tokens: int, completion_tokens: int) -> dict:
    return {
        "id": request_id,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": usage_dict(prompt_tokens, completion_tokens),
    }


def chat_choice(index: int, text: str, finish_reason: Optional[str],
                logprobs: Optional[dict] = None) -> dict:
    return {
        "index": index,
        "message": {"role": "assistant", "content": text},
        "logprobs": logprobs,
        "finish_reason": finish_reason,
    }


def chat_stream_chunk(request_id: str, model: str, delta: str,
                      finish_reason: Optional[str], index: int = 0,
                      logprobs: Optional[dict] = None,
                      usage: Optional[dict] = None) -> dict:
    chunk = {
        "id": request_id,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": index,
            "delta": {"content": delta} if delta else {},
            "logprobs": logprobs,
            "finish_reason": finish_reason,
        }],
    }
    if usage is not None:
        chunk["usage"] = usage
    return chunk


def error_response(message: str, code: int = 400) -> dict:
    return {"error": {"message": message, "type": "invalid_request_error",
                      "code": code}}
