#!/usr/bin/env python
"""HTTP load test for the port's serving frontend (`cli serve`; the port's
own copy of the JAX package's `scripts/loadtest.py`, standard library only).

Sustained tokens/s and latency percentiles under CONCURRENT load:

    python -m bitdistiller_tpu_torch.scripts.loadtest --host 127.0.0.1 \
        --port 8000 --concurrency 16 --requests 64 --prompt-tokens 128 --max-new 128

Measures per request: wall latency, prefill time and decode tokens as
reported by the engine, and (with --stream) TTFT = time to the first SSE
token. Prints one JSON summary line. `run_load` also takes a list of URLs,
one a body, so one run can mix /generate (JSON and SSE), the OpenAI
endpoints and GETs of /health and /metrics (a body of None).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request


def _percentile(xs, p):
    """Nearest-rank percentile (ceil(p/100*N)-th order statistic); None on
    empty input so the JSON summary stays strictly parseable."""
    if not xs:
        return None
    xs = sorted(xs)
    import math
    i = max(math.ceil(p / 100.0 * len(xs)) - 1, 0)
    return xs[min(i, len(xs) - 1)]


def one_request(url: str, body, stream: bool, out: list, lock, timeout: float = 600):
    """One request: a GET where `body` is None, else a POST of the JSON body
    (its own "stream" key, where it has one, overrides `stream`)."""
    if body is None:
        req = urllib.request.Request(url)
    else:
        stream = bool(body.get("stream", stream))
        data = json.dumps(dict(body, stream=stream)).encode()
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": "application/json"}
        )
    t0 = time.time()
    rec = {"ok": False, "url": url}
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            if body is None:
                rec.update(ok=resp.status == 200, tokens=0, bytes=len(resp.read()))
            elif stream:
                ttft = None
                n_tok = 0
                final = {}
                for line in resp:
                    line = line.strip()
                    if not line.startswith(b"data: ") or line == b"data: [DONE]":
                        continue
                    payload = json.loads(line[6:])
                    if "token" in payload or "choices" in payload:
                        n_tok += 1
                        if ttft is None:
                            ttft = time.time() - t0
                    if payload.get("done"):
                        final = payload
                rec.update(ok=True, ttft_s=ttft, tokens=n_tok,
                           finish_reason=final.get("finish_reason"))
            else:
                payload = json.loads(resp.read())
                if "usage" in payload:  # the OpenAI endpoints
                    payload["decode_tokens"] = payload["usage"]["completion_tokens"]
                rec.update(
                    ok=True,
                    tokens=payload.get("decode_tokens", 0),
                    prefill_s=payload.get("prefill_time_s"),
                    decode_s=payload.get("decode_time_s"),
                    finish_reason=payload.get("finish_reason"),
                )
    except Exception as e:  # timeouts / refused / server errors
        rec["error"] = f"{type(e).__name__}: {e}"
    rec["latency_s"] = time.time() - t0
    with lock:
        out.append(rec)


def run_load(url, bodies: list, concurrency: int, stream: bool = False,
             timeout: float = 600) -> dict:
    """Fire `bodies` at the server with at most `concurrency` in flight;
    returns the summary dict (also usable in-process). `url` is one URL for
    every body or a list of URLs, one a body."""
    results: list = []
    lock = threading.Lock()
    # fixed worker pool draining a queue: one thread per REQUEST would
    # reserve ~8 MB of stack each and hit thread limits on soak runs
    import queue as _q

    work: "_q.Queue" = _q.Queue()
    urls = [url] * len(bodies) if isinstance(url, str) else list(url)
    for job in zip(urls, bodies):
        work.put(job)

    def worker():
        while True:
            try:
                job_url, body = work.get_nowait()
            except _q.Empty:
                return
            one_request(job_url, body, stream, results, lock, timeout)

    t0 = time.time()
    threads = [threading.Thread(target=worker)
               for _ in range(min(concurrency, len(bodies)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0

    ok = [r for r in results if r.get("ok")]
    lat = [r["latency_s"] for r in ok]
    toks = sum(r.get("tokens", 0) for r in ok)
    rnd = lambda v: round(v, 3) if v is not None else None
    summary = {
        "requests": len(results),
        "ok": len(ok),
        "errors": len(results) - len(ok),
        "wall_s": round(wall, 3),
        "throughput_tok_s": round(toks / wall, 1) if wall else 0.0,
        "latency_p50_s": rnd(_percentile(lat, 50)),
        "latency_p90_s": rnd(_percentile(lat, 90)),
        "latency_p99_s": rnd(_percentile(lat, 99)),
    }
    ttfts = [r["ttft_s"] for r in ok if r.get("ttft_s") is not None]
    if ttfts:
        summary["ttft_p50_s"] = rnd(_percentile(ttfts, 50))
        summary["ttft_p90_s"] = rnd(_percentile(ttfts, 90))
    prefills = [r["prefill_s"] for r in ok if r.get("prefill_s") is not None]
    if prefills:
        summary["prefill_p50_s"] = rnd(_percentile(prefills, 50))
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--concurrency", type=int, default=16)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--prompt", default=None, help="text prompt (needs server tokenizer)")
    ap.add_argument("--prompt-tokens", type=int, default=128,
                    help="synthetic prompt length (token ids 3..vocab-)")
    ap.add_argument("--vocab", type=int, default=32000)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--stream", action="store_true", help="measure TTFT over SSE")
    args = ap.parse_args(argv)

    import random

    rng = random.Random(0)
    bodies = []
    for _ in range(args.requests):
        if args.prompt is not None:
            body = {"prompt": args.prompt}
        else:
            body = {"prompt_tokens": [rng.randrange(3, args.vocab)
                                      for _ in range(args.prompt_tokens)]}
        body.update(max_new_tokens=args.max_new, temperature=args.temperature)
        bodies.append(body)

    url = f"http://{args.host}:{args.port}/generate"
    summary = run_load(url, bodies, args.concurrency, stream=args.stream)
    print(json.dumps(summary))
    return 0 if summary["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
