"""Online serving: a JSON-over-HTTP frontend on the continuous-batching
engine (PyTorch port of the JAX package's `serve/server.py`).

Requests arrive over HTTP at any time, join the engine's slot batch
mid-flight (Engine.run's feeder), carry their own sampling params, and are
answered when they finish. Standard library only (http.server): the engine
loop runs in the thread that calls `serve_forever` (it owns the card), the
HTTP handlers in daemon threads. A handler only enqueues a Request and
reads Python values (the request's tokens, the engine's host counters); it
never touches a device tensor.

API:
  POST /generate  {"prompt": str | "prompt_tokens": [int], "max_new_tokens",
                   "temperature", "top_k", "top_p", "repetition_penalty",
                   "stop_token_ids", "template", "cache_prompt", "stream"}
     -> {"text", "tokens", "finish_reason", "prefill_time_s",
         "decode_tokens", "decode_time_s"}; with "stream": one SSE `data:`
         line a token, then {"done": true, ...}
  GET  /health    -> {"ok": true, "active_slots": n, "queued": n, ...}
  GET  /metrics   -> Prometheus text exposition of the engine counters
  POST /v1/completions, /v1/chat/completions: OpenAI-compatible mappings
       (max_tokens, messages rendered through the template's multi-turn
       form, `stop` strings, usage accounting, SSE chunks ending in
       [DONE]).

A sharded engine (`Engine(..., mesh=)` over a (dp, tp) group) is served
by global rank 0 alone: rank 0 runs the frontend, every other rank runs
`follow(engine)`, whose loop takes the requests and the stop that rank 0
broadcasts each round.
"""

from __future__ import annotations

import json
import queue
import threading

from .engine import Engine, Request
from .sampling import SamplingParams

_SAMPLING_KEYS = ("temperature", "top_k", "top_p", "repetition_penalty")


class ServingFrontend:
    """HTTP server + engine loop. `serve_forever()` runs the engine in the
    calling thread (it owns the card) and HTTP handlers in daemon threads;
    `shutdown()` (from any thread) lets in-flight requests finish and ends
    the loop. Port 0 binds a free port (`address` holds it)."""

    def __init__(self, engine: Engine, tokenizer, host="127.0.0.1", port=8000,
                 template: str = "raw"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.engine = engine
        self.tok = tokenizer
        self.template = template  # chat-message rendering (utils/prompts)
        self.timeout_s = 600.0  # per-request generation timeout
        self.queue: "queue.Queue[Request]" = queue.Queue()
        self._stop = threading.Event()
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                eng = frontend.engine
                if self.path == "/health":
                    return self._json(200, {
                        "ok": True,
                        "active_slots": int(eng.active.sum()),
                        "queued": frontend.queue.qsize(),
                        "prompt_cache_hits": eng.prompt_cache_hits,
                        "prompt_cache_misses": eng.prompt_cache_misses,
                    })
                if self.path == "/metrics":
                    # prometheus text exposition of the engine counters
                    lines = [
                        f"bdt_active_slots {int(eng.active.sum())}",
                        f"bdt_queued_requests {frontend.queue.qsize()}",
                        f"bdt_prompt_cache_hits {eng.prompt_cache_hits}",
                        f"bdt_prompt_cache_prefix_hits {eng.prompt_cache_prefix_hits}",
                        f"bdt_prompt_cache_misses {eng.prompt_cache_misses}",
                        f"bdt_spec_verify_cells {eng.spec_rounds}",
                        f"bdt_spec_tokens {eng.spec_tokens}",
                    ]
                    body = ("\n".join(lines) + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    return self.wfile.write(body)
                return self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path not in ("/generate", "/v1/completions",
                                     "/v1/chat/completions"):
                    return self._json(404, {"error": "not found"})
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if self.path != "/generate":
                        return self._openai(body, chat="chat" in self.path)
                    req = frontend._build_request(body)
                except Exception as e:  # malformed request
                    return self._json(400, {"error": str(e)})
                if body.get("stream"):
                    return self._stream(req)
                evt = threading.Event()
                req.on_finish = lambda _r: evt.set()
                frontend.queue.put(req)
                if not evt.wait(timeout=frontend.timeout_s):
                    return self._json(504, {"error": "generation timed out"})
                self._json(200, {
                    "text": frontend.tok.decode(req.output_tokens),
                    "tokens": req.output_tokens,
                    "finish_reason": req.finish_reason,
                    "prefill_time_s": req.prefill_time,
                    "decode_tokens": req.decode_tokens,
                    "decode_time_s": req.decode_time,
                })

            def _openai(self, body, chat: bool):
                """OpenAI-compatible surface: /v1/completions and
                /v1/chat/completions (point existing SDK clients at the
                engine). Sampling keys map 1:1; `max_tokens` ->
                max_new_tokens; chat messages render in order through the
                template's multi-turn form (utils.prompts.render_chat);
                `stop` strings that tokenize to one token match as token
                ids, longer ones match host-side against the decoded tail
                at emit time and are cut from the returned text."""
                try:
                    mapped = {
                        k: body[k] for k in _SAMPLING_KEYS if k in body
                    }
                    mapped["max_new_tokens"] = int(body.get("max_tokens", 256))
                    stops = body.get("stop") or []
                    if isinstance(stops, str):
                        stops = [stops]
                    stop_ids, stop_strs = [], []
                    for s in stops:
                        ids = frontend.tok.encode(s)
                        if len(ids) == 1:
                            stop_ids.append(int(ids[0]))
                        else:
                            stop_strs.append(s)
                    mapped["stop_token_ids"] = stop_ids
                    if chat:
                        mapped["rendered_prompt"] = frontend._render_chat(
                            body["messages"]
                        )
                    else:
                        mapped["prompt"] = body["prompt"]
                    req = frontend._build_request(mapped)
                    if stop_strs:
                        req.stop_check = frontend._make_stop_check(stop_strs)
                except Exception as e:
                    return self._json(400, {"error": str(e)})
                obj = "chat.completion" if chat else "text_completion"
                if body.get("stream"):
                    return self._stream(req, openai_chat=chat)
                evt = threading.Event()
                req.on_finish = lambda _r: evt.set()
                frontend.queue.put(req)
                if not evt.wait(timeout=frontend.timeout_s):
                    return self._json(504, {"error": "generation timed out"})
                text = frontend.tok.decode(req.output_tokens)
                # OpenAI semantics: the matched stop string is excluded
                for s in stop_strs:
                    cut = text.find(s)
                    if cut >= 0:
                        text = text[:cut]
                choice = {"index": 0, "finish_reason": req.finish_reason}
                if chat:
                    choice["message"] = {"role": "assistant", "content": text}
                else:
                    choice["text"] = text
                self._json(200, {
                    "id": f"cmpl-{id(req):x}",
                    "object": obj,
                    "model": body.get("model", "bitdistiller-tpu-torch"),
                    "choices": [choice],
                    "usage": {
                        "prompt_tokens": len(req.prompt_tokens),
                        "completion_tokens": len(req.output_tokens),
                        "total_tokens": len(req.prompt_tokens)
                        + len(req.output_tokens),
                    },
                })

            def _stream(self, req, openai_chat=None):
                """Server-sent events: one `data:` line per token as the
                engine emits it (stream_gen.py's per-token yield, over HTTP)."""
                tokens: "queue.Queue" = queue.Queue()
                req.stream = tokens.put
                req.on_finish = lambda _r: tokens.put(None)
                frontend.queue.put(req)
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.end_headers()
                while True:
                    try:
                        t = tokens.get(timeout=frontend.timeout_s)
                    except queue.Empty:
                        # never leave the client hanging without a
                        # terminator: emit an error event, then close
                        if openai_chat is None:
                            payload = {"done": True, "error": "timeout",
                                       "finish_reason": "error"}
                            self.wfile.write(
                                f"data: {json.dumps(payload)}\n\n".encode()
                            )
                        else:
                            self.wfile.write(
                                b'data: {"error": "timeout"}\n\n'
                                b"data: [DONE]\n\n"
                            )
                        self.wfile.flush()
                        return
                    if openai_chat is None:  # native /generate SSE shape
                        if t is None:
                            payload = {"done": True,
                                       "finish_reason": req.finish_reason,
                                       "text": frontend.tok.decode(req.output_tokens)}
                        else:
                            payload = {"token": int(t),
                                       "text": frontend.tok.decode([t])}
                    elif t is None:  # OpenAI stream terminator
                        self.wfile.write(b"data: [DONE]\n\n")
                        self.wfile.flush()
                        return
                    else:  # OpenAI chunk shape
                        piece = frontend.tok.decode([t])
                        delta = ({"delta": {"content": piece}} if openai_chat
                                 else {"text": piece})
                        payload = {"object": "chat.completion.chunk"
                                   if openai_chat else "text_completion",
                                   "choices": [dict(delta, index=0,
                                                    finish_reason=None)]}
                    self.wfile.write(f"data: {json.dumps(payload)}\n\n".encode())
                    self.wfile.flush()
                    if t is None:
                        return

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.address = self.httpd.server_address  # resolved port when port=0

    def _render_chat(self, messages: list) -> str:
        from ..utils.prompts import render_chat

        return render_chat(self.template, messages)

    def _make_stop_check(self, stop_strs: list):
        """Host-side multi-token stop matching: decode only the output tail
        (longest stop + slack for multi-token characters) after each emitted
        token and substring-match. The matched text is cut from the final
        response; already-streamed SSE pieces are not retracted."""
        tail = max(len(s) for s in stop_strs) + 8
        tok = self.tok

        def check(output_tokens: list) -> bool:
            text = tok.decode(output_tokens[-tail:])
            return any(s in text for s in stop_strs)

        return check

    def _build_request(self, body: dict) -> Request:
        if "prompt_tokens" in body:
            toks = [int(t) for t in body["prompt_tokens"]]
        elif "rendered_prompt" in body:  # chat endpoint: already templated
            toks = self.tok.encode(body["rendered_prompt"])
        else:
            prompt = body["prompt"]
            if body.get("template"):
                from ..utils.prompts import render_prompt

                prompt = render_prompt(body["template"], prompt)
            toks = self.tok.encode(prompt)
        sampling = None
        if any(k in body for k in _SAMPLING_KEYS):
            base = self.engine.sampling
            sampling = SamplingParams(
                temperature=float(body.get("temperature", base.temperature)),
                top_k=int(body.get("top_k", base.top_k)),
                top_p=float(body.get("top_p", base.top_p)),
                repetition_penalty=float(
                    body.get("repetition_penalty", base.repetition_penalty)
                ),
            )
            if sampling == base:
                # identical to the engine defaults: stay on the uniform
                # sampling fast path (the custom path pays a per-step
                # [B, V] sort for top-p once ANY active slot is custom)
                sampling = None
        return Request(
            prompt_tokens=toks,
            max_new_tokens=int(body.get("max_new_tokens", 256)),
            sampling=sampling,
            stop_token_ids=tuple(body.get("stop_token_ids", ())),
            cache_prompt=bool(body.get("cache_prompt", False)),
        )

    def _feeder(self, idle: bool) -> list:
        out = []
        try:
            if idle:  # nothing decoding: block briefly instead of spinning
                out.append(self.queue.get(timeout=0.05))
            while True:
                out.append(self.queue.get_nowait())
        except queue.Empty:
            pass
        return out

    def serve_forever(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        try:
            self.engine.run([], feeder=self._feeder, stop=self._stop.is_set)
        finally:
            self.httpd.shutdown()
            self.httpd.server_close()

    def shutdown(self):
        self._stop.set()


def follow(engine: Engine) -> list:
    """The engine loop of a rank other than global rank 0 of a sharded
    engine (`Engine(..., mesh=)`, every rank of the group running it): rank
    0 runs the `ServingFrontend`, and this loop serves the requests and the
    stop that rank 0 broadcasts each round (this rank's feeder is never
    called), until rank 0's frontend shuts down. Returns the requests it
    served, as rank 0 answered them."""
    return engine.run([], feeder=lambda idle: [], stop=lambda: False)
