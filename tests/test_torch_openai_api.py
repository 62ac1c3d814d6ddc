"""The port's OpenAI surface (kubetorch_tpu_torch/serve/openai_api.py)
against the JAX package's, request for request.

Both engines are built from one numpy tree (``models/convert.py``), fp32
on the CPU, and both apps are served with aiohttp's ``TestClient``. Every
case of ``tests/test_openai_api.py`` is sent to both; the JSON bodies
must be equal apart from ``id`` and ``created`` (greedy tokens, text
through ``FakeTokenizer``, finish reasons, SSE chunk sequences, usage,
error statuses and messages, prefix routes, ``echo``), with logprobs and
embeddings within 1e-5 (the same fp32 math, summed in another order).
Seeded sampling draws from each package's own generator (ROADMAP Queue C,
deliberate difference 2), so ``best_of`` and seeded ``n`` are held by
their properties. The engines are module-scoped: each JAX shape compiles
once for the whole file.
"""

import asyncio
import json
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import jax
import jax.numpy as jnp
from aiohttp.test_utils import TestClient, TestServer

from kubetorch_tpu.models.llama import LlamaConfig as JaxConfig
from kubetorch_tpu.serve import GenerationEngine as JaxEngine
from kubetorch_tpu.serve import quantize_params as jax_quantize_params
from kubetorch_tpu.serve.openai_api import _TextStopCutter as JaxCutter
from kubetorch_tpu.serve.openai_api import build_app as jax_build_app
from kubetorch_tpu_torch.models.convert import params_from_numpy
from kubetorch_tpu_torch.models.generate import generate
from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_hidden
from kubetorch_tpu_torch.serve import GenerationEngine, quantize_params
from kubetorch_tpu_torch.serve.openai_api import (ChunkStream, OpenAIApp,
                                                  _TextStopCutter, build_app)

from .test_torch_llama import np_params

pytestmark = pytest.mark.level("unit")

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-5
ENGINE = dict(slots=4, max_len=64, prefill_buckets=(8,), auto_prefix=True)


class FakeTokenizer:
    """Deterministic toy text⇄ids map: each char c ⇄ id ord(c). Decode is
    the inverse, so text assertions are exact."""

    def encode(self, text):
        return [ord(c) % 512 for c in text]

    def decode(self, ids):
        return "".join(chr(i) for i in ids)


def pt_cfg():
    return LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def tree():
    return np_params(JaxConfig.tiny(), seed=0)


@pytest.fixture(scope="module")
def params(tree):
    return params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def engines(tree, params):
    """(JAX engine, port engine) over the same weights, loop threads on."""
    jcfg = JaxConfig.tiny(attn_impl="xla", dtype=jnp.float32, remat=False)
    jeng = JaxEngine(jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
                     **ENGINE).start()
    peng = GenerationEngine(params, pt_cfg(), device="cpu", **ENGINE).start()
    yield jeng, peng
    jeng.stop()
    peng.stop()


def _greedy(params, prompt, n):
    out = generate(params, torch.tensor([prompt]), pt_cfg(), max_new_tokens=n)
    return out[0, len(prompt):].tolist()


def same(a, b, path="$"):
    """Equal JSON apart from response ids and ``created``; floats within
    TOL."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, a, b)
        for k in a:
            if k == "created" or (k == "id" and isinstance(a[k], str)
                                  and a[k].startswith(("cmpl-", "chatcmpl-"))):
                continue
            same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert isinstance(b, float) and abs(a - b) <= TOL * max(1.0, abs(a)), \
            (path, a, b)
    else:
        assert a == b, (path, a, b)


def run_both(engines, body, tokenizer=None):
    """``body(both)`` with ``both(method, path, **kw)`` sending one request
    to the JAX app and the port's app; returns the port's response."""
    jeng, peng = engines

    async def runner():
        jc = TestClient(TestServer(jax_build_app(jeng, tokenizer,
                                                 model_name="tiny")))
        pc = TestClient(TestServer(build_app(peng, tokenizer,
                                             model_name="tiny")))
        await jc.start_server()
        await pc.start_server()
        try:
            await body(Both(jc, pc))
        finally:
            await jc.close()
            await pc.close()

    asyncio.run(runner())


class Both:
    def __init__(self, jc, pc):
        self.jc, self.pc = jc, pc

    async def raw(self, method, path, **kw):
        rj = await getattr(self.jc, method)(path, **kw)
        rp = await getattr(self.pc, method)(path, **kw)
        assert rp.status == rj.status, (path, kw, rj.status, rp.status)
        assert (rp.headers["Content-Type"].split(";")[0]
                == rj.headers["Content-Type"].split(";")[0])
        return rj, rp

    async def json(self, method, path, strict=True, **kw):
        """(status, port body); with ``strict`` the bodies must be the
        same, else only their statuses."""
        rj, rp = await self.raw(method, path, **kw)
        want, got = await rj.json(), await rp.json()
        if strict:
            same(want, got)
        return rp.status, got

    async def sse(self, path, **kw):
        rj, rp = await self.raw("post", path, **kw)
        assert rp.headers["Content-Type"].startswith("text/event-stream")
        want, got = await _sse_events(rj), await _sse_events(rp)
        same(want, got)
        return got


async def _sse_events(resp):
    events = []
    async for line in resp.content:
        line = line.decode().strip()
        if not line.startswith("data: "):
            continue
        payload = line[len("data: "):]
        events.append(payload if payload == "[DONE]"
                      else json.loads(payload))
    return events


def test_models_endpoint(engines):
    async def body(both):
        status, data = await both.json("get", "/v1/models")
        assert status == 200
        assert data["data"][0]["id"] == "tiny"
    run_both(engines, body)


def test_completions_token_id_mode_matches_oracle(engines, params):
    prompt = [5, 17, 42, 99]
    want = _greedy(params, prompt, 8)

    async def body(both):
        status, data = await both.json("post", "/v1/completions", json={
            "model": "tiny", "prompt": prompt, "max_tokens": 8,
            "temperature": 0})
        assert status == 200
        choice = data["choices"][0]
        assert choice["token_ids"] == want
        assert choice["finish_reason"] == "length"
        assert data["usage"]["completion_tokens"] == 8
    run_both(engines, body)


def test_completions_text_mode_roundtrip(engines):
    tok = FakeTokenizer()

    async def body(both):
        status, data = await both.json("post", "/v1/completions", json={
            "model": "tiny", "prompt": "hi!", "max_tokens": 6,
            "temperature": 0})
        assert status == 200
        choice = data["choices"][0]
        assert choice["text"] == tok.decode(choice["token_ids"])
    run_both(engines, body, tokenizer=tok)


def test_string_stop_cuts_and_hides_stop_text(engines, params):
    tok = FakeTokenizer()
    prompt_text = "ab"
    full_text = tok.decode(_greedy(params, tok.encode(prompt_text), 10))
    stop = full_text[2:4]
    first = full_text.find(stop)

    async def body(both):
        _, data = await both.json("post", "/v1/completions", json={
            "model": "tiny", "prompt": prompt_text, "max_tokens": 10,
            "temperature": 0, "stop": stop})
        choice = data["choices"][0]
        assert choice["text"] == full_text[:first]
        assert choice["finish_reason"] == "stop"
        # streamed: the stop string cancels the request and ends the stream
        events = await both.sse("/v1/completions", json={
            "model": "tiny", "prompt": prompt_text, "max_tokens": 10,
            "temperature": 0, "stop": stop, "stream": True})
        assert "".join(e["choices"][0]["text"] for e in events[:-1]) \
            == full_text[:first]
        assert events[-2]["choices"][0]["finish_reason"] == "stop"
        # the JAX app's pump thread drains the cancelled handle after the
        # response and posts to this event loop: a few more engine steps
        # retire it while the loop still runs
        await both.json("post", "/v1/completions", json={
            "prompt": prompt_text, "max_tokens": 4, "temperature": 0})
    run_both(engines, body, tokenizer=tok)


def test_token_id_stop_finish_reason(engines, params):
    prompt = [7, 8, 9]
    full = _greedy(params, prompt, 8)

    async def body(both):
        _, data = await both.json("post", "/v1/completions", json={
            "model": "tiny", "prompt": prompt, "max_tokens": 8,
            "temperature": 0, "stop": [full[2:4]]})
        choice = data["choices"][0]
        assert choice["finish_reason"] == "stop"
        assert choice["token_ids"] == full[:full.index(full[2]) + 2] \
            or choice["token_ids"][-2:] == full[2:4]
        # streamed, the token-id stop is the finish chunk's reason
        events = await both.sse("/v1/completions", json={
            "model": "tiny", "prompt": prompt, "max_tokens": 8,
            "temperature": 0, "stop": [full[2:4]], "stream": True})
        assert events[-2]["choices"][0]["finish_reason"] == "stop"
        assert [t for e in events[:-1]
                for t in e["choices"][0]["token_ids"]] == choice["token_ids"]
    run_both(engines, body)


def test_streaming_sse_matches_blocking(engines, params):
    prompt = [5, 17, 42, 99]
    want = _greedy(params, prompt, 6)
    req = {"model": "tiny", "prompt": prompt, "max_tokens": 6,
           "temperature": 0, "stream": True}

    async def body(both):
        events = await both.sse("/v1/completions", json=req)
        assert events[-1] == "[DONE]"
        toks = [t for e in events[:-1] for t in e["choices"][0]["token_ids"]]
        assert toks == want
        assert events[-2]["choices"][0]["finish_reason"] == "length"
        # the wire bytes too, with the ids and timestamps masked
        rj, rp = await both.raw("post", "/v1/completions", json=req)
        mask = [(r'"id": "cmpl-\d+"', '"id": ""'),
                (r'"created": \d+', '"created": 0')]
        wire = []
        for r in (rj, rp):
            text = (await r.read()).decode()
            for pat, rep in mask:
                text = re.sub(pat, rep, text)
            wire.append(text)
        assert wire[1] == wire[0]
        assert wire[1].endswith("data: [DONE]\n\n")
    run_both(engines, body)


def test_chat_completions_template_fallback(engines):
    tok = FakeTokenizer()

    async def body(both):
        status, data = await both.json("post", "/v1/chat/completions", json={
            "model": "tiny", "max_tokens": 4, "temperature": 0,
            "messages": [{"role": "user", "content": "yo"}]})
        assert status == 200
        msg = data["choices"][0]["message"]
        assert msg["role"] == "assistant"
        assert msg["content"] == tok.decode(msg["token_ids"])
        assert data["object"] == "chat.completion"
    run_both(engines, body, tokenizer=tok)


def test_chat_streaming_delta_chunks(engines):
    tok = FakeTokenizer()

    async def body(both):
        events = await both.sse("/v1/chat/completions", json={
            "model": "tiny", "max_tokens": 4, "temperature": 0,
            "stream": True,
            "messages": [{"role": "user", "content": "yo"}]})
        assert events[-1] == "[DONE]"
        text = "".join(e["choices"][0]["delta"].get("content", "")
                       for e in events[:-1]
                       if isinstance(e["choices"][0].get("delta"), dict))
        ids = [t for e in events[:-1]
               for t in e["choices"][0].get("token_ids", [])]
        assert text == tok.decode(ids)
        assert events[0]["object"] == "chat.completion.chunk"
    run_both(engines, body, tokenizer=tok)


def test_openai_shaped_errors(engines):
    async def body(both):
        status, data = await both.json("post", "/v1/completions", json={
            "model": "tiny", "prompt": "text", "max_tokens": 2})
        assert status == 400
        err = data["error"]
        assert err["type"] == "invalid_request_error"
        assert "tokenizer" in err["message"]
        for path, req in (
                ("/v1/completions",
                 {"model": "tiny", "prompt": [1, 2], "max_tokens": 2, "n": 0}),
                ("/v1/chat/completions",
                 {"model": "tiny", "max_tokens": 2,
                  "messages": [{"role": "user", "content": "x"}]}),
                ("/v1/completions",
                 {"model": "tiny", "prompt": [1, 2], "max_tokens": 2,
                  "top_p": 0.0})):
            status, _ = await both.json("post", path, json=req)
            assert status == 400
        status, _ = await both.json("post", "/v1/completions",
                                    data=b"not json")
        assert status == 400
    run_both(engines, body)


@pytest.mark.parametrize("stops,pieces", [
    (["END"], ["abcE", "N", "Dxyz"]),
    ([], ["anything"]),
    (["ab", "xyz"], ["x", "y", "a", "b", "z"]),
    (["", "q"], ["pq", "r"]),
])
def test_text_stop_cutter_split_across_pieces(stops, pieces):
    ours, theirs = _TextStopCutter(stops), JaxCutter(stops)
    for piece in pieces:
        assert ours.feed(piece) == theirs.feed(piece)
    assert ours.flush() == theirs.flush()
    c = _TextStopCutter(["END"])
    out = [c.feed(p) for p in ("abcE", "N", "Dxyz")]
    assert [d for _, d in out] == [False, False, True]
    assert "".join(o for o, _ in out) == "abc"


def test_logprobs_blocking_and_streaming(engines):
    prompt = [5, 17, 42, 99]

    async def body(both):
        _, data = await both.json("post", "/v1/completions", json={
            "model": "tiny", "prompt": prompt, "max_tokens": 5,
            "temperature": 0, "logprobs": 1})
        lp = data["choices"][0]["logprobs"]
        assert len(lp["token_logprobs"]) == 5
        assert all(isinstance(x, float) and x <= 0
                   for x in lp["token_logprobs"])
        assert len(lp["tokens"]) == 5
        events = await both.sse("/v1/completions", json={
            "model": "tiny", "prompt": prompt, "max_tokens": 5,
            "temperature": 0, "logprobs": True, "stream": True})
        lps = [e["choices"][0]["logprob"] for e in events[:-1]
               if e["choices"][0].get("token_ids")]
        assert lps == lp["token_logprobs"]
        status, _ = await both.json("post", "/v1/completions", json={
            "model": "tiny", "prompt": prompt, "max_tokens": 2,
            "logprobs": 5})
        assert status == 400
    run_both(engines, body)


def test_chat_logprobs_content_format(engines):
    async def body(both):
        _, data = await both.json("post", "/v1/chat/completions", json={
            "model": "tiny", "max_tokens": 3, "temperature": 0,
            "logprobs": True,
            "messages": [{"role": "user", "content": "yo"}]})
        content = data["choices"][0]["logprobs"]["content"]
        assert len(content) == 3
        assert all("token" in c and c["logprob"] <= 0 for c in content)
    run_both(engines, body, tokenizer=FakeTokenizer())


def test_penalties_pass_through(engines):
    async def body(both):
        _, data = await both.json("post", "/v1/completions", json={
            "model": "tiny", "prompt": [5, 17, 42], "max_tokens": 8,
            "temperature": 0, "presence_penalty": 1e9})
        seen = {5, 17, 42}
        for t in data["choices"][0]["token_ids"]:
            assert t not in seen
            seen.add(t)
    run_both(engines, body)


def test_embeddings_endpoint(engines):
    async def body(both):
        status, data = await both.json("post", "/v1/embeddings", json={
            "model": "tiny", "input": "hello"})
        assert status == 200
        assert data["object"] == "list" and len(data["data"]) == 1
        e1 = data["data"][0]["embedding"]
        assert len(e1) == 64
        assert data["usage"]["prompt_tokens"] == 5
        _, data = await both.json("post", "/v1/embeddings", json={
            "model": "tiny", "input": ["hello", "world"]})
        assert [d["index"] for d in data["data"]] == [0, 1]
        assert data["data"][0]["embedding"] == e1
        assert data["data"][1]["embedding"] != e1
        _, data = await both.json("post", "/v1/embeddings", json={
            "model": "tiny", "input": [5, 17, 42]})
        assert len(data["data"]) == 1
        assert len(data["data"][0]["embedding"]) == 64
        status, _ = await both.json("post", "/v1/embeddings",
                                    json={"model": "tiny", "input": None})
        assert status == 400
        # longer than the engine's max_len: the same refusal
        status, _ = await both.json("post", "/v1/embeddings",
                                    json={"input": list(range(65))})
        assert status == 400
    run_both(engines, body, tokenizer=FakeTokenizer())


def test_embedding_is_the_mean_over_the_real_tokens(engines, params):
    """Right-padded to the bucket, the pooled state is the unpadded
    sequence's mean: the padded tail reaches no real row."""
    ids = [5, 17, 42, 7, 300]
    _, peng = engines
    with torch.no_grad():
        h = llama_hidden(params, torch.tensor([ids]), pt_cfg())[0]
    got = torch.tensor(OpenAIApp(peng)._embed_ids(ids))
    torch.testing.assert_close(got, h.mean(0), rtol=TOL, atol=TOL)


def test_prefix_routes_and_auto_prefix(engines, params):
    prefix = [5, 17, 42, 7, 9, 11]
    suffix = [99, 100]
    want = _greedy(params, prefix + suffix, 6)
    hits = engines[1]._prefix_hits

    async def body(both):
        status, data = await both.json("post", "/v1/prefixes",
                                        json={"tokens": prefix})
        assert status == 200 and data["n_tokens"] == len(prefix)
        pid = data["prefix_id"]
        status, data = await both.json("post", "/v1/completions", json={
            "prompt": prefix + suffix, "max_tokens": 6, "temperature": 0})
        assert status == 200
        assert data["choices"][0]["token_ids"] == want
        status, data = await both.json("delete", f"/v1/prefixes/{pid}")
        assert status == 200 and data == {"deleted": pid}
        status, _ = await both.json("delete", f"/v1/prefixes/{pid}")
        assert status == 404

    run_both(engines, body)
    assert engines[1]._prefix_hits == hits + 1


def test_prefix_route_errors(engines):
    async def body(both):
        for req in ({}, {"text": "hi"}, {"tokens": []}, {"tokens": ["x"]}):
            status, _ = await both.json("post", "/v1/prefixes", json=req)
            assert status == 400, req
        status, _ = await both.json("post", "/v1/prefixes", data=b"{")
        assert status == 400

    run_both(engines, body)


def test_n_choices_and_logit_bias(engines):
    async def body(both):
        status, data = await both.json("post", "/v1/completions", json={
            "prompt": [5, 17, 42], "max_tokens": 4, "temperature": 0,
            "n": 2})
        assert status == 200
        ch = data["choices"]
        assert [c["index"] for c in ch] == [0, 1]
        assert ch[0]["token_ids"] == ch[1]["token_ids"]
        assert data["usage"]["completion_tokens"] == 8
        _, data = await both.json("post", "/v1/completions", json={
            "prompt": [5, 17, 42], "max_tokens": 3, "temperature": 0,
            "logit_bias": {"77": 1000.0}})
        assert data["choices"][0]["token_ids"] == [77, 77, 77]
        status, data = await both.json("post", "/v1/completions", json={
            "prompt": [1, 2], "max_tokens": 2, "n": 2, "stream": True})
        assert status == 400
        assert "n > 1" in data["error"]["message"]

    run_both(engines, body)


def test_malformed_n_and_logit_bias_are_400s(engines):
    async def body(both):
        status, _ = await both.json("post", "/v1/completions", json={
            "prompt": [1, 2], "max_tokens": 2, "n": None, "temperature": 0})
        assert status == 200
        for payload in ({"n": "two"}, {"n": 129}, {"n": 0},
                        {"logit_bias": [7, 1.5]},
                        {"logit_bias": {"7": None}},
                        {"logit_bias": {"9999": 1.0}},
                        {"stop": [[1], 2]}, {"stop": ["a"]},
                        {"stop": ["a", "b", "c", "d", "e"]}):
            status, data = await both.json("post", "/v1/completions", json={
                "prompt": [1, 2], "max_tokens": 2, **payload})
            assert status == 400, (payload, status)
            assert data["error"]["type"] == "invalid_request_error"

    run_both(engines, body)


def _choice_shapes(data):
    return [(c["index"], len(c["token_ids"]), c["finish_reason"])
            for c in data["choices"]]


def test_seeded_n_choices_are_distinct_but_reproducible(engines):
    """Each package samples from its own generator: the properties are
    held on both, and the bodies' shapes are equal."""
    req = {"prompt": [5, 17, 42], "max_tokens": 6, "temperature": 1.0,
           "n": 3, "seed": 7}

    async def body(both):
        outs = {"jax": [], "port": []}
        for _ in range(2):
            rj, rp = await both.raw("post", "/v1/completions", json=req)
            dj, dp = await rj.json(), await rp.json()
            assert _choice_shapes(dj) == _choice_shapes(dp)
            assert dj["usage"] == dp["usage"]
            for name, d in (("jax", dj), ("port", dp)):
                outs[name].append([tuple(c["token_ids"])
                                   for c in d["choices"]])
        for name, o in outs.items():
            assert o[0] == o[1], name               # reproducible per index
            assert len(set(o[0])) == 3, name        # distinct across n
        # choice 0 of a seeded n > 1 call is the solo call with that seed
        _, solo = await both.json("post", "/v1/completions", strict=False,
                                  json=dict(req, n=1))
        assert tuple(solo["choices"][0]["token_ids"]) == outs["port"][0][0]
        for bad in (2.9, True):
            status, _ = await both.json("post", "/v1/completions", json={
                "prompt": [1, 2], "max_tokens": 2, "n": bad})
            assert status == 400

    run_both(engines, body)


def test_best_of_and_echo(engines):
    async def body(both):
        rj, rp = await both.raw("post", "/v1/completions", json={
            "prompt": [5, 17, 42], "max_tokens": 4, "temperature": 1.0,
            "n": 2, "best_of": 4, "seed": 3, "logprobs": True})
        assert rp.status == 200, await rp.text()
        dj, d = await rj.json(), await rp.json()
        assert _choice_shapes(dj) == _choice_shapes(d)
        assert dj["usage"] == d["usage"]
        assert d["usage"]["completion_tokens"] == 16

        def mean_lp(c):
            lps = [x for x in c["logprobs"]["token_logprobs"]
                   if x is not None]
            return sum(lps) / len(lps)
        for data in (dj, d):
            assert mean_lp(data["choices"][0]) >= mean_lp(data["choices"][1])
        # echo: the prompt ids lead the completion; their logprobs None
        _, data = await both.json("post", "/v1/completions", json={
            "prompt": [5, 17, 42], "max_tokens": 3, "temperature": 0,
            "echo": True, "logprobs": True})
        c = data["choices"][0]
        assert c["token_ids"][:3] == [5, 17, 42]
        assert len(c["token_ids"]) == 6
        assert c["logprobs"]["token_logprobs"][:3] == [None] * 3
        for path, req in (
                ("/v1/chat/completions", {"messages": [], "best_of": 2}),
                ("/v1/completions", {"prompt": [1], "n": 3, "best_of": 2}),
                ("/v1/completions", {"prompt": [1], "best_of": 2,
                                     "stream": True}),
                ("/v1/completions", {"prompt": [1], "best_of": 2.5})):
            status, _ = await both.json("post", path, json=req)
            assert status == 400

    run_both(engines, body)


def test_best_of_ranks_on_visible_text(engines):
    """With a text stop, the ranking scores only the tokens up to the stop
    (the per-token decodes both packages use), greedy so the candidates
    are the same on both sides."""
    async def body(both):
        _, data = await both.json("post", "/v1/completions", json={
            "prompt": "ab", "max_tokens": 6, "temperature": 0, "n": 1,
            "best_of": 2, "stop": "zz", "logprobs": True})
        assert len(data["choices"]) == 1
        assert data["usage"]["completion_tokens"] == 12

    run_both(engines, body, tokenizer=FakeTokenizer())


def test_echo_refusals(engines):
    async def body(both):
        status, _ = await both.json("post", "/v1/completions", json={
            "prompt": [1, 2], "max_tokens": 2, "echo": True,
            "stream": True})
        assert status == 400
        status, _ = await both.json("post", "/v1/chat/completions", json={
            "messages": [{"role": "user", "content": "x"}], "echo": True})
        assert status == 400
        # echo with text: the prompt's text leads the completion's
        _, data = await both.json("post", "/v1/completions", json={
            "prompt": "ab", "max_tokens": 3, "temperature": 0, "echo": True})
        assert data["choices"][0]["text"].startswith("ab")

    run_both(engines, body, tokenizer=FakeTokenizer())


def test_embeddings_refuse_quantized_engine(tree, params):
    jcfg = JaxConfig.tiny(attn_impl="xla", dtype=jnp.float32, remat=False)
    kw = dict(slots=1, max_len=32, prefill_buckets=(4,))
    jeng = JaxEngine(jax_quantize_params(jax.tree_util.tree_map(
        jnp.asarray, tree)), jcfg, **kw).start()
    peng = GenerationEngine(quantize_params(params), pt_cfg(), device="cpu",
                            **kw).start()
    out = {}

    async def body(both):
        out["r"] = await both.json("post", "/v1/embeddings",
                                   json={"input": [1, 2, 3]})

    try:
        run_both((jeng, peng), body)
    finally:
        jeng.stop()
        peng.stop()
    status, data = out["r"]
    assert status == 400 and "full-precision" in data["error"]["message"]


def test_plain_methods_give_the_route_payloads(engines):
    """The plain methods, driven with no HTTP at all, return what the
    routes serve (the routes are shells over them)."""
    _, peng = engines
    tok = FakeTokenizer()
    app = OpenAIApp(peng, tok, model_name="tiny")
    completion = {"prompt": "hey", "max_tokens": 5, "temperature": 0,
                  "logprobs": True}
    chat = {"messages": [{"role": "user", "content": "yo"}],
            "max_tokens": 3, "temperature": 0}
    routes = {}

    async def body(client):
        for key, method, path, req in (
                ("models", "get", "/v1/models", None),
                ("completion", "post", "/v1/completions", completion),
                ("chat", "post", "/v1/chat/completions", chat),
                ("embed", "post", "/v1/embeddings", {"input": ["ab", "c"]}),
                ("bad", "post", "/v1/completions", {"prompt": [1], "n": 0}),
                ("stream", "post", "/v1/completions",
                 dict(completion, stream=True))):
            r = await getattr(client, method)(path, json=req)
            routes[key] = (r.status, await (_sse_events(r) if key == "stream"
                                            else r.json()))

    async def runner():
        client = TestClient(TestServer(app.build()))
        await client.start_server()
        try:
            await body(client)
        finally:
            await client.close()

    asyncio.run(runner())
    plain = {"models": app.list_models(),
             "completion": app._serve(completion, chat=False),
             "chat": app._serve(chat, chat=True),
             "embed": app.embed({"input": ["ab", "c"]}),
             "bad": app._serve({"prompt": [1], "n": 0}, chat=False)}
    status, stream = app._serve(dict(completion, stream=True), chat=False)
    assert isinstance(stream, ChunkStream)
    plain["stream"] = (status, list(stream) + ["[DONE]"])
    for key, (status, payload) in plain.items():
        assert status == routes[key][0], key
        same(json.loads(json.dumps(payload)), routes[key][1])
    status, data = app.add_prefix({"tokens": [1, 2, 3]})
    assert status == 200 and data["n_tokens"] == 3
    assert app.remove_prefix(data["prefix_id"]) == (
        200, {"deleted": data["prefix_id"]})
    assert app.remove_prefix(data["prefix_id"])[0] == 404


def test_serve_imports_and_answers_without_aiohttp():
    """With aiohttp unimportable, ``kubetorch_tpu_torch.serve`` imports, an
    ``OpenAIApp`` builds over an engine and answers through its plain
    methods; only ``build()`` needs aiohttp."""
    code = """
import sys
sys.modules["aiohttp"] = None
import torch
from kubetorch_tpu_torch.models.llama import LlamaConfig, llama_init
from kubetorch_tpu_torch.serve import GenerationEngine, OpenAIApp
cfg = LlamaConfig.tiny(dtype=torch.float32)
eng = GenerationEngine(llama_init(cfg, device="cpu"), cfg, slots=1,
                       max_len=32, prefill_buckets=(8,), device="cpu").start()
app = OpenAIApp(eng)
status, data = app._serve({"prompt": [1, 2, 3], "max_tokens": 3,
                           "temperature": 0}, chat=False)
assert status == 200 and len(data["choices"][0]["token_ids"]) == 3, data
assert app.list_models()[0] == 200
try:
    app.build()
except ImportError:
    print("build needs aiohttp")
eng.stop()
assert "aiohttp" not in [m for m in sys.modules if sys.modules[m] is not None]
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() [-4:] == ["build", "needs", "aiohttp", "ok"]
