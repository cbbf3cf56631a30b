"""The port's HTTP frontend (`serve/server.py`) and load tester
(`scripts/loadtest.py`) on the CPU: the JAX package's tests/test_server.py
scenarios against the port's own engine (greedy over HTTP equals the
engine's greedy tokens), and the port's prompt templates against the JAX
package's for every template. Every server binds port 0, every client call
has a timeout of at most 30 s, and every server is shut down in a
`finally`."""

import contextlib
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from bitdistiller_tpu.models import TINY_TEST, init_params
from bitdistiller_tpu.models.quantized import pack_model
from bitdistiller_tpu.utils import prompts as jprompts
from bitdistiller_tpu_torch.models.quantized import params_from_numpy
from bitdistiller_tpu_torch.scripts import loadtest
from bitdistiller_tpu_torch.serve import Engine, SamplingParams
from bitdistiller_tpu_torch.serve.server import ServingFrontend
from bitdistiller_tpu_torch.utils import prompts as tprompts
from torch_port_util import to_numpy_tree, torch_cfg

CFG = dataclasses.replace(TINY_TEST, dtype="float32")
TIMEOUT = 30


class CharTok:
    def encode(self, s):
        return [(ord(c) % 250) + 3 for c in s]

    def decode(self, ids, **kw):
        return "".join(chr((i - 3) % 26 + 97) for i in ids)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tparams():
    jp = pack_model(init_params(CFG, jax.random.key(0), dtype=jnp.float32), CFG, bits=2,
                    group_size=64)
    return params_from_numpy(to_numpy_tree(jp), "cpu")


def _engine(tparams, **kw):
    return Engine(tparams, torch_cfg(CFG), max_slots=2, max_len=64,
                  sampling=SamplingParams(temperature=1.0), eos_token_id=None,
                  cache_dtype=torch.float32, device="cpu", **kw)


@contextlib.contextmanager
def serving(eng, loop=True):
    """A frontend on port 0; the engine loop in a thread (or, with
    loop=False, the HTTP side alone); shut down and joined on exit."""
    front = ServingFrontend(eng, CharTok(), port=0)
    target = front.serve_forever if loop else front.httpd.serve_forever
    t = threading.Thread(target=target, daemon=True)
    t.start()
    host, port = front.address
    try:
        yield front, f"http://{host}:{port}"
    finally:
        if loop:
            front.shutdown()
        else:
            front.httpd.shutdown()
            front.httpd.server_close()
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()


@pytest.fixture()
def frontend(tparams):
    with serving(_engine(tparams)) as (front, url):
        yield front, url


def _post(url, body, path="/generate"):
    req = urllib.request.Request(f"{url}{path}", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return json.load(resp)


def _greedy(tparams, text, n):
    eng = Engine(tparams, torch_cfg(CFG), max_slots=1, max_len=64,
                 sampling=SamplingParams(temperature=0.0), eos_token_id=None,
                 cache_dtype=torch.float32, device="cpu")
    return eng.generate([CharTok().encode(text)], max_new_tokens=n)[0]


def test_health_and_greedy_generate(frontend, tparams):
    front, url = frontend
    with urllib.request.urlopen(f"{url}/health", timeout=TIMEOUT) as resp:
        h = json.load(resp)
    assert h["ok"] and h["active_slots"] == 0 and h["queued"] == 0
    out = _post(url, {"prompt": "hello", "max_new_tokens": 5, "temperature": 0.0})
    assert out["finish_reason"] == "length"
    assert out["tokens"] == _greedy(tparams, "hello", 5)
    assert out["text"] == CharTok().decode(out["tokens"])
    assert out["decode_tokens"] == 4 and out["prefill_time_s"] > 0


def test_concurrent_mixed_params_and_bad_request(frontend):
    front, url = frontend
    results = {}

    def hit(name, body):
        results[name] = _post(url, body)

    bodies = {"a": {"prompt": "abc", "max_new_tokens": 8, "temperature": 0.0},
              "b": {"prompt": "defgh", "max_new_tokens": 8},
              "c": {"prompt_tokens": [5, 9, 4], "max_new_tokens": 8, "temperature": 1.3,
                    "top_k": 4}}
    threads = [threading.Thread(target=hit, args=item) for item in bodies.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert set(results) == set(bodies)
    assert all(len(r["tokens"]) == 8 and r["decode_tokens"] > 0 for r in results.values())
    req = urllib.request.Request(f"{url}/generate", b"{}", {"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=TIMEOUT)
    assert e.value.code == 400


def test_stop_token_ids(frontend):
    front, url = frontend
    base = _post(url, {"prompt": "xyz", "max_new_tokens": 6, "temperature": 0.0})
    stop = base["tokens"][1]
    out = _post(url, {"prompt": "xyz", "max_new_tokens": 6, "temperature": 0.0,
                      "stop_token_ids": [stop]})
    assert out["tokens"] == base["tokens"][:base["tokens"].index(stop) + 1]
    assert out["finish_reason"] == "stop"


def test_sse_streaming(frontend):
    front, url = frontend
    base = _post(url, {"prompt": "stream", "max_new_tokens": 5, "temperature": 0.0})
    req = urllib.request.Request(
        f"{url}/generate", json.dumps({"prompt": "stream", "max_new_tokens": 5,
                                       "temperature": 0.0, "stream": True}).encode(),
        {"Content-Type": "application/json"})
    toks, done = [], None
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        for line in resp:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            evt = json.loads(line[6:])
            if evt.get("done"):
                done = evt
                break
            toks.append(evt["token"])
    assert toks == base["tokens"]
    assert done["finish_reason"] == "length" and done["text"] == base["text"]


def test_openai_endpoints_and_metrics(frontend):
    front, url = frontend
    out = _post(url, {"prompt": "hello", "max_tokens": 5, "temperature": 0.0},
                "/v1/completions")
    assert out["object"] == "text_completion"
    assert out["choices"][0]["finish_reason"] == "length"
    assert out["usage"]["completion_tokens"] == 5
    assert out["usage"]["total_tokens"] == out["usage"]["prompt_tokens"] + 5
    native = _post(url, {"prompt": "hello", "max_new_tokens": 5, "temperature": 0.0})
    assert out["choices"][0]["text"] == native["text"]
    chat = _post(url, {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 4,
                       "temperature": 0.0}, "/v1/chat/completions")
    assert chat["object"] == "chat.completion"
    assert chat["choices"][0]["message"]["role"] == "assistant"
    assert len(chat["choices"][0]["message"]["content"]) == 4
    req = urllib.request.Request(
        f"{url}/v1/chat/completions",
        json.dumps({"messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
                    "temperature": 0.0, "stream": True}).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        lines = [ln for ln in resp if ln.startswith(b"data: ")]
    assert lines[-1].strip() == b"data: [DONE]"
    chunks = [json.loads(ln[6:]) for ln in lines[:-1]]
    assert len(chunks) == 3 and all(c["object"] == "chat.completion.chunk" for c in chunks)
    with urllib.request.urlopen(f"{url}/metrics", timeout=TIMEOUT) as resp:
        metrics = resp.read()
    for name in (b"bdt_active_slots", b"bdt_prompt_cache_prefix_hits", b"bdt_spec_tokens"):
        assert name in metrics


def test_openai_chat_renders_the_whole_message_list(frontend):
    front, url = frontend
    front.template = "chatml"
    seen = []
    real = front.tok.encode
    front.tok = CharTok()
    front.tok.encode = lambda s: (seen.append(s), real(s))[1]
    msgs = [{"role": "system", "content": "sys"}, {"role": "user", "content": "q1"},
            {"role": "assistant", "content": "a1"}, {"role": "user", "content": "q2"}]
    out = _post(url, {"messages": msgs, "max_tokens": 2, "temperature": 0.0},
                "/v1/chat/completions")
    assert out["choices"][0]["message"]["content"]
    assert seen and seen[0] == jprompts.render_chat("chatml", msgs)


def test_openai_multi_token_stop_string(frontend):
    """A stop string of two tokens matches through the request's stop_check:
    reason "stop", the string cut from the text."""
    front, url = frontend
    base = _post(url, {"prompt": "hello", "max_tokens": 12, "temperature": 0.0},
                 "/v1/completions")
    full = base["choices"][0]["text"]
    stop = full[5:7]
    out = _post(url, {"prompt": "hello", "max_tokens": 12, "temperature": 0.0, "stop": stop},
                "/v1/completions")
    assert out["choices"][0]["finish_reason"] == "stop"
    assert out["choices"][0]["text"] == full[:full.find(stop)]


def test_cache_prompt_over_the_wire(tparams):
    with serving(_engine(tparams, prompt_cache_size=2)) as (front, url):
        body = {"prompt": "sys", "max_new_tokens": 4, "temperature": 0.0, "cache_prompt": True}
        a = _post(url, body)
        b = _post(url, dict(body, cache_prompt=False))
        assert a["text"] == b["text"]
        with urllib.request.urlopen(f"{url}/health", timeout=TIMEOUT) as resp:
            h = json.load(resp)
        assert h["prompt_cache_hits"] == 1 and h["prompt_cache_misses"] == 1


def test_sse_timeout_sends_terminator(tparams):
    """No engine loop: the stream still ends with an error event and
    [DONE] after the frontend's timeout."""
    with serving(_engine(tparams), loop=False) as (front, url):
        front.timeout_s = 0.3
        req = urllib.request.Request(
            f"{url}/v1/completions",
            json.dumps({"prompt": "hi", "max_tokens": 3, "stream": True}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            lines = [ln for ln in resp if ln.strip()]
        assert lines[-2].strip() == b'data: {"error": "timeout"}'
        assert lines[-1].strip() == b"data: [DONE]"


def test_run_load_json_sse_and_a_mixed_run(frontend):
    """The port's load tester: JSON and SSE traffic at /generate, then one
    run mixing every endpoint (GETs for a body of None)."""
    front, url = frontend
    bodies = [{"prompt_tokens": [3 + (i % 7), 5, 9], "max_new_tokens": 4, "temperature": 0.0}
              for i in range(6)]
    summary = loadtest.run_load(f"{url}/generate", bodies, concurrency=3, timeout=TIMEOUT)
    assert summary["errors"] == 0 and summary["ok"] == 6
    assert summary["throughput_tok_s"] > 0 and summary["prefill_p50_s"] >= 0
    assert summary["latency_p50_s"] <= summary["latency_p99_s"]
    sse = loadtest.run_load(f"{url}/generate", bodies[:3], concurrency=2, stream=True,
                            timeout=TIMEOUT)
    assert sse["errors"] == 0 and sse["ok"] == 3 and sse["ttft_p50_s"] > 0
    jobs = [("/generate", bodies[0]), ("/generate", dict(bodies[1], stream=True)),
            ("/v1/completions", {"prompt": "ab", "max_tokens": 3, "temperature": 0.0}),
            ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                      "max_tokens": 3, "stop": "zz"}),
            ("/health", None), ("/metrics", None)]
    mixed = loadtest.run_load([url + p for p, _ in jobs], [b for _, b in jobs], concurrency=4,
                              timeout=TIMEOUT)
    assert mixed["errors"] == 0 and mixed["ok"] == len(jobs)


def test_loadtest_main_parses_and_reports(frontend, capsys):
    front, url = frontend
    host, port = front.address
    rc = loadtest.main(["--host", host, "--port", str(port), "--concurrency", "2",
                        "--requests", "2", "--prompt-tokens", "4", "--vocab", "200",
                        "--max-new", "2"])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and summary["ok"] == 2


# ---- the prompt templates ----------------------------------------------------------


MESSAGES = [
    [{"role": "user", "content": "hi"}],
    [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"}],
    [{"role": "system", "content": "be brief"}, {"role": "user", "content": "hi"},
     {"role": "assistant", "content": "hello!"}, {"role": "user", "content": "how are you?"}],
    [{"role": "user", "content": "a"}, {"role": "user", "content": "b"},
     {"role": "assistant", "content": "c"}],
]


@pytest.mark.parametrize("template", sorted(jprompts.TEMPLATES))
def test_templates_render_as_jax(template):
    assert sorted(tprompts.TEMPLATES) == sorted(jprompts.TEMPLATES)
    for system in ("", "sys text"):
        assert (tprompts.render_prompt(template, "q?", system)
                == jprompts.render_prompt(template, "q?", system))
    for msgs in MESSAGES:
        assert tprompts.render_chat(template, msgs) == jprompts.render_chat(template, msgs)


def test_unknown_template_raises():
    with pytest.raises(ValueError, match="unknown template"):
        tprompts.render_prompt("nope", "x")
    with pytest.raises(ValueError, match="unknown template"):
        tprompts.render_chat("nope", MESSAGES[0])
