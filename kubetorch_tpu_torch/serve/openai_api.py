"""OpenAI-compatible surface over the port's ``GenerationEngine``: the
counterpart of ``kubetorch_tpu/serve/openai_api.py``, with its routes,
statuses and wire bytes.

``/v1/completions`` and ``/v1/chat/completions`` (blocking and SSE
streaming), ``/v1/embeddings``, ``/v1/models``, and the prefix-cache
extension ``/v1/prefixes`` — so off-the-shelf clients (openai-python,
LangChain, curl scripts) talk to an engine unchanged.

Design:

- **Plain methods, thin HTTP shells.** Every route's work — body
  validation, submission, the blocking response, the stream's chunk
  sequence, embeddings, prefixes — is a plain method that takes a decoded
  JSON body and returns ``(status, payload)``; a valid streaming request
  returns a :class:`ChunkStream` in place of the payload, which yields the
  SSE chunk dicts one decoded token at a time. The aiohttp handlers only
  decode the body, run the plain method off the event loop and frame its
  result (``data: {...}\\n\\n`` chunks, then ``data: [DONE]``). aiohttp is
  imported only by ``build()``, ``build_app`` and ``main``, so the surface
  runs (and is driven, e.g. on a machine without aiohttp) through the
  plain methods alone.
- **Tokenizer optional.** With a HF tokenizer (``AutoTokenizer`` or any
  object with encode/decode), prompts and outputs are text and string
  ``stop`` is honored by incremental decode + cut. Without one, prompts
  must be token-id lists and outputs are ids.

Supported wire fields: ``max_tokens``, ``temperature``, ``top_p``,
``stop`` (strings, or token-id lists), ``stream``, ``seed`` (choice ``i``
samples with ``seed + i``), ``n``, ``best_of`` and ``echo``
(completions), ``logprobs`` (the chosen token's only), penalties and
``logit_bias``. Anything else the engine cannot honor refuses with an
OpenAI-shaped error.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import threading
import time
from typing import Any, Dict, Iterator, List, Tuple

import torch

__all__ = ["OpenAIApp", "ChunkStream", "build_app"]

_NOT_JSON = object()     # a request body that did not decode


@torch.no_grad()
def _pooled_hidden(params, tokens: torch.Tensor, true_len: int,
                   cfg) -> torch.Tensor:
    """(1, T_bucket) right-padded → (D,) fp32 mean over the real tokens of
    the final-norm hidden states. Causal attention keeps the padded tail
    out of the real rows; the mean divides by the true length."""
    from ..models.llama import llama_hidden

    h = llama_hidden(params, tokens, cfg).float()
    mask = (torch.arange(h.shape[1], device=h.device) < true_len)[None, :, None]
    return (h * mask).sum(dim=(0, 1)) / max(true_len, 1)


def _error(status: int, message: str,
           err_type: str = "invalid_request_error") -> Tuple[int, dict]:
    return status, {"error": {"message": message, "type": err_type,
                              "param": None, "code": None}}


class _TextStopCutter:
    """Incremental string-stop matching over a decoded stream: feed text
    pieces, returns (emittable_text, done). Holds back a window of
    ``max_stop - 1`` chars so a stop string split across tokens still
    matches; on match, everything before the stop is emitted and the stop
    itself is dropped (OpenAI semantics — unlike token-id stops, which
    mirror eos and emit)."""

    def __init__(self, stops: List[str]):
        self.stops = [s for s in stops if s]
        self.buf = ""
        self.hold = max((len(s) for s in self.stops), default=1) - 1

    def feed(self, piece: str):
        if not self.stops:
            return piece, False
        self.buf += piece
        cut = min((i for i in (self.buf.find(s) for s in self.stops)
                   if i >= 0), default=-1)
        if cut >= 0:
            out, self.buf = self.buf[:cut], ""
            return out, True
        out = self.buf[:-self.hold] if self.hold else self.buf
        self.buf = self.buf[len(out):]
        return out, False

    def flush(self) -> str:
        out, self.buf = self.buf, ""
        return out


class ChunkStream:
    """A validated streaming request. Iterating yields the SSE chunk dicts
    (blocking on the engine, one per decoded token, then the finish chunk;
    the ``[DONE]`` sentinel is the framing's). ``cancel()`` frees the
    request's slot when the client hangs up."""

    def __init__(self, chunks: Iterator[dict], handle):
        self._chunks = chunks
        self.handle = handle

    def __iter__(self) -> Iterator[dict]:
        return self._chunks

    def cancel(self) -> None:
        self.handle.cancel()


class OpenAIApp:
    """The OpenAI surface over ``engine``: plain methods per route (module
    docstring), ``build()`` → an aiohttp Application over them.
    ``tokenizer`` is any HF-style object (``encode``/``decode``,
    optionally ``apply_chat_template``); None = token-id mode."""

    def __init__(self, engine, tokenizer=None,
                 model_name: str = "kubetorch-tpu"):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        self._req_ids = itertools.count(1)

    # -- translation helpers ------------------------------------------------

    def _encode_prompt(self, prompt) -> List[int]:
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError(
                    "string prompts need a tokenizer; this deployment is "
                    "token-id mode — send a list of token ids")
            return list(self.tokenizer.encode(prompt))
        if isinstance(prompt, list) and all(isinstance(t, int) for t in prompt):
            return prompt
        raise ValueError("prompt must be a string or a list of token ids")

    def _split_stops(self, stop) -> Tuple[List[str], List[List[int]]]:
        """OpenAI ``stop`` (str or list of str; token-id lists accepted
        too) → (text_stops, token_stops)."""
        if stop is None:
            return [], []
        items = [stop] if isinstance(stop, str) else list(stop)
        if len(items) > 4:
            raise ValueError("at most 4 stop sequences")
        text, toks = [], []
        for s in items:
            if isinstance(s, str):
                text.append(s)
            elif isinstance(s, list) and all(isinstance(t, int) for t in s):
                toks.append(s)
            else:
                raise ValueError("stop entries must be strings or "
                                 "token-id lists")
        if text and self.tokenizer is None:
            raise ValueError("string stop sequences need a tokenizer")
        return text, toks

    def _chat_prompt(self, messages) -> List[int]:
        if not isinstance(messages, list) or not messages:
            raise ValueError("messages must be a non-empty list")
        for m in messages:
            if not isinstance(m, dict) or "role" not in m or "content" not in m:
                raise ValueError("each message needs role and content")
        if self.tokenizer is None:
            raise ValueError("chat completions need a tokenizer")
        apply = getattr(self.tokenizer, "apply_chat_template", None)
        if apply is not None:
            try:
                return list(apply(messages, add_generation_prompt=True,
                                  tokenize=True))
            except Exception:
                pass  # template-less tokenizer: fall through
        text = "".join(f"<|{m['role']}|>{m['content']}\n" for m in messages)
        return list(self.tokenizer.encode(text + "<|assistant|>"))

    def _decode(self, ids: List[int]) -> str:
        return self.tokenizer.decode(ids) if self.tokenizer else ""

    def _submit(self, body: Dict[str, Any], prompt_ids: List[int],
                choice_index: int = 0):
        lp = body.get("logprobs")
        if (isinstance(lp, int) and lp > 1) or body.get("top_logprobs"):
            raise ValueError("only the chosen token's logprob is available "
                             "(logprobs=1/true); top-k logprobs are not "
                             "supported")
        text_stops, tok_stops = self._split_stops(body.get("stop"))
        temperature = float(body.get("temperature", 1.0))
        top_p = body.get("top_p")
        # OpenAI wire shape {"token_id_string": bias_float} passes through
        # raw: engine.submit normalizes and range-validates the dict
        bias = body.get("logit_bias") or None
        handle = self.engine.submit(
            prompt_ids,
            max_new_tokens=int(body.get("max_tokens", 16)),
            temperature=temperature,
            top_p=None if top_p is None else float(top_p),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            stop=tok_stops or None, logit_bias=bias,
            # a seeded stream is a pure function of (seed, prompt), so n>1
            # with one seed would return n identical choices — each index
            # gets its own derived seed, and index 0 reproduces solo calls
            seed=(None if body.get("seed") is None
                  else int(body["seed"]) + choice_index))
        return handle, _TextStopCutter(text_stops), tok_stops

    # -- plain methods: decoded body in, (status, payload) out --------------

    def _embed_ids(self, ids: List[int]) -> List[float]:
        """Mean-pooled final-norm hidden state for one input (dense,
        full-precision models), at the engine's prefill bucket."""
        from ..models.quant import is_quantized

        eng = self.engine
        if "router" in eng.params.get("layers", {}):
            raise ValueError("embeddings are not supported for MoE models")
        if any(is_quantized(v) for v in eng.params["layers"].values()):
            # llama_hidden is the full-precision forward; refuse cleanly
            # instead of failing inside it on a dict leaf
            raise ValueError(
                "embeddings need full-precision params — this engine "
                "serves quantized weights (generation only)")
        if len(ids) > eng.max_len:
            raise ValueError(f"input ({len(ids)} tokens) exceeds max_len "
                             f"({eng.max_len})")
        bucket = next((b for b in eng._buckets if b >= len(ids)),
                      eng.max_len)
        padded = torch.zeros((1, bucket), dtype=torch.long)
        padded[0, :len(ids)] = torch.tensor(ids, dtype=torch.long)
        hidden = _pooled_hidden(eng.params, padded.to(eng.device), len(ids),
                                eng.cfg)
        return hidden.cpu().tolist()

    def embed(self, body) -> Tuple[int, dict]:
        """``POST /v1/embeddings``."""
        raw = body.get("input")
        if isinstance(raw, str):
            items = [raw]
        elif isinstance(raw, list) and raw \
                and all(isinstance(t, int) for t in raw):
            items = [raw]            # one token-id sequence
        elif isinstance(raw, list) and raw:
            items = raw
        else:
            return _error(400, "input must be a string, a token-id list, "
                               "or a list of those")
        data, total = [], 0
        try:
            for i, item in enumerate(items):
                ids = self._encode_prompt(item)
                total += len(ids)
                data.append({"object": "embedding", "index": i,
                             "embedding": self._embed_ids(ids)})
        except ValueError as e:
            return _error(400, str(e))
        return 200, {"object": "list", "data": data, "model": self.model_name,
                     "usage": {"prompt_tokens": total, "total_tokens": total}}

    def list_models(self) -> Tuple[int, dict]:
        """``GET /v1/models``."""
        return 200, {"object": "list", "data": [
            {"id": self.model_name, "object": "model",
             "created": int(time.time()), "owned_by": "kubetorch-tpu"}]}

    def _serve(self, body, chat: bool) -> Tuple[int, Any]:
        """``POST /v1/completions`` (``chat=False``) and
        ``/v1/chat/completions``: the payload, blocking until every choice
        has decoded; a :class:`ChunkStream` for a valid streaming
        request."""
        raw_n = body.get("n")
        # null means "use the default", per OpenAI; bools and floats are
        # not integers (int() would silently truncate 2.9 to 2)
        if raw_n is None:
            n = 1
        elif isinstance(raw_n, int) and not isinstance(raw_n, bool):
            n = raw_n
        else:
            return _error(400, f"n must be an integer, got {raw_n!r}")
        if not 1 <= n <= 128:        # OpenAI's own cap
            return _error(400, f"n must be in [1, 128], got {n}")
        if n > 1 and body.get("stream"):
            return _error(400, "streaming with n > 1 is not supported")
        best_of = body.get("best_of")
        if best_of is not None:
            if chat:
                return _error(400, "best_of applies to /v1/completions only")
            if not (isinstance(best_of, int)
                    and not isinstance(best_of, bool)):
                return _error(400, f"best_of must be an integer, "
                                   f"got {best_of!r}")
            if not n <= best_of <= 128:
                return _error(400, f"best_of must be in [n, 128], "
                                   f"got {best_of} (n={n})")
            if body.get("stream"):
                return _error(400, "streaming with best_of is not supported")
        if body.get("echo"):
            # explicit refusals mirror OpenAI: echo is a completions-only,
            # non-streaming field — silently dropping it would hand back
            # wrong output to a client relying on it
            if chat:
                return _error(400, "echo applies to /v1/completions only")
            if body.get("stream"):
                return _error(400, "streaming with echo is not supported")
        n_submit = best_of if best_of is not None else n
        try:
            prompt_ids = (self._chat_prompt(body.get("messages"))
                          if chat else self._encode_prompt(body.get("prompt")))
            # the candidates decode concurrently on the slot grid, each
            # drawing its own sampling stream
            pairs = []
            try:
                for i in range(n_submit):
                    h, cutter, tok_stops = self._submit(body, prompt_ids,
                                                        choice_index=i)
                    pairs.append((h, cutter))
            except Exception:
                for h, _c in pairs:      # don't strand earlier submissions
                    h.cancel()
                raise
        except (ValueError, KeyError, TypeError, AttributeError) as e:
            # TypeError/AttributeError: malformed wire fields (a list
            # logit_bias, a null bias value) surface from the submit
            # normalization — client errors, not server faults
            return _error(400, str(e))
        rid = f"{'chatcmpl' if chat else 'cmpl'}-{next(self._req_ids)}"
        want_logprobs = bool(body.get("logprobs"))
        if body.get("stream"):
            (handle, cutter), = pairs
            return 200, ChunkStream(
                self._stream(handle, cutter, rid, chat, tok_stops,
                             want_logprobs), handle)
        return self._blocking(pairs, rid, chat, prompt_ids, tok_stops,
                              want_logprobs, keep_n=n,
                              echo=bool(body.get("echo")) and not chat)

    def _finished_by_stop(self, ids: List[int], tok_stops) -> bool:
        if (self.engine.eos_id is not None and ids
                and ids[-1] == self.engine.eos_id):
            return True
        return any(len(q) <= len(ids) and ids[len(ids) - len(q):] == list(q)
                   for q in tok_stops)

    def _blocking(self, pairs, rid, chat, prompt_ids, tok_stops,
                  want_logprobs=False, keep_n=None,
                  echo=False) -> Tuple[int, dict]:
        n_prompt = len(prompt_ids)
        results = []
        for index, (handle, cutter) in enumerate(pairs):
            try:
                ids = handle.result()
            except Exception as e:  # admission error surfaced via handle
                for h, _c in pairs[index + 1:]:
                    h.cancel()
                return _error(400, str(e))
            results.append((ids, handle.logprobs, cutter))
        total = sum(len(ids) for ids, _lp, _c in results)
        if keep_n is not None and keep_n < len(results):
            # best_of: rank candidates by mean token logprob (the OpenAI
            # rule) over the VISIBLE tokens — a text stop hides the tail
            # at response-build time, and scoring dropped text would let
            # a worse visible completion win. Token stops/eos retire the
            # request in-engine, so only text stops can leave a tail.
            # Usage still counts EVERY candidate's tokens (all decoded).
            # The visible length comes from per-token decodes, as the
            # JAX package finds it.
            def visible(ids, cutter):
                if self.tokenizer is None or not cutter.stops:
                    return len(ids)
                acc = ""
                for i, t in enumerate(ids):
                    acc += self._decode([t])
                    if any(s in acc for s in cutter.stops):
                        return i + 1
                return len(ids)

            def score(r):
                ids, lp_list, cutter = r
                lps = [lp for lp in lp_list[:visible(ids, cutter)]
                       if lp is not None]
                return sum(lps) / len(lps) if lps else float("-inf")
            results = sorted(results, key=score, reverse=True)[:keep_n]
        echo_text = (self._decode(list(prompt_ids))
                     if echo and self.tokenizer is not None else None)
        choices = []
        for index, (ids, lp_list, cutter) in enumerate(results):
            text = None
            finish = "stop" if self._finished_by_stop(ids, tok_stops) \
                else "length"
            if self.tokenizer is not None:
                piece, matched = cutter.feed(self._decode(ids))
                text = piece if matched else piece + cutter.flush()
                if matched:
                    finish = "stop"
            lps = lp_list if want_logprobs else None
            if echo:
                # OpenAI echo: the prompt rides in front of the
                # completion (prompt tokens carry no logprobs)
                ids = list(prompt_ids) + ids
                if text is not None:
                    text = echo_text + text
                if lps is not None:
                    lps = [None] * n_prompt + lps
            if chat:
                choice = {"index": index, "finish_reason": finish,
                          "message": {"role": "assistant",
                                      "content": text if text is not None
                                      else None,
                                      "token_ids": ids}}
                if lps is not None:
                    choice["logprobs"] = {"content": [
                        {"token": self._decode([t]) if self.tokenizer
                         else str(t),
                         "logprob": lp, "bytes": None}
                        for t, lp in zip(ids, lps)]}
            else:
                choice = {"index": index, "finish_reason": finish,
                          "text": text if text is not None else "",
                          "token_ids": ids}
                if lps is not None:
                    choice["logprobs"] = {
                        "tokens": [self._decode([t]) if self.tokenizer
                                   else str(t) for t in ids],
                        "token_logprobs": lps,
                        "top_logprobs": None, "text_offset": None}
            choices.append(choice)
        usage = {"prompt_tokens": n_prompt, "completion_tokens": total,
                 "total_tokens": n_prompt + total}
        obj = "chat.completion" if chat else "text_completion"
        return 200, {"id": rid, "object": obj, "created": int(time.time()),
                     "model": self.model_name, "choices": choices,
                     "usage": usage}

    def _stream(self, handle, cutter, rid, chat, tok_stops,
                want_logprobs=False) -> Iterator[dict]:
        """The SSE chunk dicts of one streaming request, one per decoded
        token (a text stop cancels the request and ends the stream), then
        the finish chunk."""

        def chunk(piece, ids, finish=None, lp=None):
            delta_key = "delta" if chat else "text"
            content = ({"content": piece} if chat else piece)
            c = {"index": 0, delta_key: content, "token_ids": ids,
                 "finish_reason": finish}
            if lp is not None:
                c["logprob"] = lp
            return {"id": rid,
                    "object": ("chat.completion.chunk" if chat
                               else "text_completion"),
                    "created": int(time.time()), "model": self.model_name,
                    "choices": [c]}

        all_ids: List[int] = []
        try:
            for tok in handle:
                lp = handle.logprobs[-1] if want_logprobs else None
                ids = [tok]
                all_ids.append(tok)
                if self.tokenizer is not None:
                    piece, matched = cutter.feed(self._decode(ids))
                    if piece:
                        yield chunk(piece, ids, lp=lp)
                    if matched:
                        # everything after the stop string is not ours to
                        # emit: cancel the request (frees the slot at the
                        # next step boundary) and close the stream now
                        handle.cancel()
                        yield chunk("", [], "stop")
                        return
                else:
                    yield chunk("", ids, lp=lp)
        except Exception:  # admission error surfaced via the handle
            yield chunk("", [], "error")
            return
        tail = cutter.flush() if self.tokenizer else ""
        if tail:
            yield chunk(tail, [])
        finish = ("stop" if self._finished_by_stop(all_ids, tok_stops)
                  else "length")
        yield chunk("", [], finish)

    def add_prefix(self, body) -> Tuple[int, dict]:
        """``POST /v1/prefixes`` (non-OpenAI extension): {"text": "..."} or
        {"tokens": [...]} prefills the prefix once and caches its K/V. With
        the engine's ``auto_prefix`` on, every later completion whose
        prompt starts with it skips recomputing those rows — register the
        system prompt here and standard OpenAI calls speed up with no
        client change."""
        if "tokens" in body:
            try:
                ids = [int(t) for t in body["tokens"]]
            except (TypeError, ValueError):
                return _error(400, "tokens must be a list of ints")
        elif "text" in body:
            if self.tokenizer is None:
                return _error(400, "no tokenizer loaded; pass token ids")
            ids = self.tokenizer.encode(body["text"])
        else:
            return _error(400, "pass 'text' or 'tokens'")
        try:
            # adapter-keyed: LoRA traffic only matches its own prefixes
            pid = self.engine.register_prefix(
                ids, adapter_id=body.get("adapter_id"))
        except (ValueError, KeyError) as e:
            return _error(400, str(e))
        return 200, {"prefix_id": pid, "n_tokens": len(ids)}

    def remove_prefix(self, pid: int) -> Tuple[int, dict]:
        """``DELETE /v1/prefixes/{pid}``."""
        if not self.engine.unregister_prefix(pid):
            return _error(404, f"unknown prefix_id {pid}", "not_found")
        return 200, {"deleted": pid}

    # -- aiohttp shells -----------------------------------------------------

    @staticmethod
    async def _body(request):
        try:
            return await request.json()
        except Exception:
            return _NOT_JSON

    @staticmethod
    def _json(status_payload):
        from aiohttp import web
        status, payload = status_payload
        return web.json_response(payload, status=status)

    async def _off_loop(self, fn, *args):
        # device work and blocking waits run off the event loop
        return await asyncio.get_running_loop().run_in_executor(None, fn,
                                                                *args)

    async def embeddings(self, request):
        body = await self._body(request)
        if body is _NOT_JSON:
            return self._json(_error(400, "body must be JSON"))
        return self._json(await self._off_loop(self.embed, body))

    async def models(self, request):
        return self._json(self.list_models())

    async def completions(self, request):
        return await self._serve_http(request, chat=False)

    async def chat_completions(self, request):
        return await self._serve_http(request, chat=True)

    async def _serve_http(self, request, chat: bool):
        body = await self._body(request)
        if body is _NOT_JSON:
            return self._json(_error(400, "body must be JSON"))
        status, payload = await self._off_loop(self._serve, body, chat)
        if isinstance(payload, ChunkStream):
            return await self._sse(request, payload)
        return self._json((status, payload))

    async def _sse(self, request, stream: ChunkStream):
        from aiohttp import web

        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache"})
        await resp.prepare(request)
        loop = asyncio.get_running_loop()
        q: asyncio.Queue = asyncio.Queue()

        def pump():
            # the chunk iterator blocks on the engine: a worker thread
            # feeds the event loop, and always ends the stream
            try:
                for c in stream:
                    loop.call_soon_threadsafe(q.put_nowait, c)
            finally:
                loop.call_soon_threadsafe(q.put_nowait, None)

        threading.Thread(target=pump, daemon=True,
                         name="kt-openai-pump").start()
        try:
            while True:
                c = await q.get()
                if c is None:
                    break
                await resp.write(f"data: {json.dumps(c)}\n\n".encode())
            await resp.write(b"data: [DONE]\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            stream.cancel()     # client hung up: free the slot
            raise
        return resp

    async def register_prefix(self, request):
        body = await self._body(request)
        if body is _NOT_JSON:
            return self._json(_error(400, "body must be JSON"))
        # the prefill runs on the device: off the event loop
        return self._json(await self._off_loop(self.add_prefix, body))

    async def unregister_prefix(self, request):
        return self._json(self.remove_prefix(int(request.match_info["pid"])))

    def build(self):
        """The aiohttp Application (imports aiohttp)."""
        from aiohttp import web

        app = web.Application()
        app.router.add_get("/v1/models", self.models)
        app.router.add_post("/v1/completions", self.completions)
        app.router.add_post("/v1/chat/completions", self.chat_completions)
        app.router.add_post("/v1/embeddings", self.embeddings)
        app.router.add_post("/v1/prefixes", self.register_prefix)
        app.router.add_delete("/v1/prefixes/{pid:\\d+}",
                              self.unregister_prefix)
        return app


def build_app(engine, tokenizer=None, model_name: str = "kubetorch-tpu"):
    return OpenAIApp(engine, tokenizer, model_name).build()


def main(argv=None):
    """Standalone server: HF checkpoint dir → engine → OpenAI API."""
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--ckpt", required=True,
                        help="HF save_pretrained directory (safetensors)")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--max-len", type=int, default=2048)
    parser.add_argument("--int8", action="store_true")
    parser.add_argument("--decode-block", type=int, default=32,
                        help="decode steps per engine step (amortizes host "
                             "overhead; 1 = step-per-token)")
    parser.add_argument("--auto-prefix", action="store_true",
                        help="reuse registered prefixes (POST /v1/prefixes) "
                             "for any prompt that starts with one")
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="chunked prefill: admit prompts longer than "
                             "this C tokens at a time between decode "
                             "blocks, so long admissions never stall "
                             "active streams (default: one-shot)")
    parser.add_argument("--no-tokenizer", action="store_true",
                        help="token-id mode (skip AutoTokenizer)")
    args = parser.parse_args(argv)

    from aiohttp import web

    from ..models.convert_hf import load_hf
    from . import GenerationEngine, quantize_params

    params, cfg = load_hf(args.ckpt, max_seq_len=args.max_len)
    if args.int8:
        params = quantize_params(params)
    tokenizer = None
    if not args.no_tokenizer:
        try:
            import transformers
        except ImportError:
            print("transformers is not installed: serving in token-id mode",
                  flush=True)
        else:
            tokenizer = transformers.AutoTokenizer.from_pretrained(args.ckpt)
    eos = getattr(tokenizer, "eos_token_id", None)
    engine = GenerationEngine(params, cfg, slots=args.slots,
                              max_len=args.max_len, eos_id=eos,
                              decode_block=args.decode_block,
                              auto_prefix=args.auto_prefix,
                              prefill_chunk=args.prefill_chunk).start()
    web.run_app(build_app(engine, tokenizer), port=args.port)


if __name__ == "__main__":
    main()
