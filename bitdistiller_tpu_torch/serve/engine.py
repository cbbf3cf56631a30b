"""Serving engine: batched prefill and slot-based continuous batching
(PyTorch port of the JAX package's `serve/engine.py`).

  * prompts are padded to power-of-two length buckets and prefilled
    together with the cache-less forward, which returns each layer's KV;
    identical prompts in one admission group share one prefill row;
  * that KV is transposed to the cache's head-major layout and written into
    the admitted slots; the first token is sampled from the prompt logits;
  * one decode step advances ALL slots a token, each at its own position,
    and a horizon of `decode_horizon` steps ends in one host sync;
  * requests finish on EOS, a stop id, a `stop_check`, their token budget or
    the cache length; `stream` sees every token and `on_finish` the request.

Options, as in the JAX package's engine:
  * `grow_cache` (default on): the KV cache starts at the smallest length
    bucket and is re-allocated at the next bucket (zeros, then a copy of the
    old planes, int8 scale planes too) before a prefill or a decode horizon
    would write past it, so a decode step reads a cache sized to the live
    contexts;
  * `prompt_cache_size` / `prompt_cache_bytes`: a request with
    `cache_prompt=True` stores its prompt's prefill rows and last logits
    (LRU by entries and by bytes); a later identical prompt skips prefill,
    and a prompt extending a stored one prefills only its tail against a
    one-row cache holding the stored rows;
  * `spec_decode`: n-gram speculative decoding. Each verify round drafts k
    tokens from the slot's own history (the last earlier occurrence of its
    trailing n-gram), runs one forward of S = k + 1 against the cache and
    keeps the longest sampled == draft prefix plus the next sampled token;
    k adapts over SPEC_K_LADDER from the acceptance EMA, and the plain
    step takes over where acceptance does not pay for the verify.

Decode and verify horizons, the JAX engine's jitted, cache-donating
`_decode` and `_spec`: the slot state lives in buffers allocated once and
updated only in place (`cur_tokens`, the slots' lengths and active mask,
`prev_tokens`, `history`, the per-slot sampling tensors, a horizon's output
rows), and one plain decode step or one verify round at draft length k is a
function of those buffers (`_plain_step`, `_verify_step`). Its route:
  * graphs, the default on the card, with or without a mesh: each step
    runs from CUDA graphs captured for its key (`_GraphTable`, keyed by
    (cache length, "uniform" | "custom" | "verify", k)). A key's first use
    runs the step eagerly (its collectives issued) and captures it right
    after; every later use replays it, and a horizon of n steps is n
    replays. Under a mesh a key's capture is a chain (`_Chain`): the piece
    is split at each collective and point-to-point operation
    (`parallel.distributed.boundary`) into segments, one CUDA graph each,
    and a replay runs graph, operation, graph, ..., the operations eager
    between them (gloo's cannot be captured: they stage through the host;
    `distributed.segmented`); an operation's buffers stay the pool's
    transients, reused by other keys (`distributed.unowned`). At mesh=None
    a chain is one graph. Growth
    drops the graphs of the cache it replaced; `warmup()` walks the keys
    before traffic. The kernels' launch counters advance on every replay
    by what the capture counted;
  * eager, on the CPU, or anywhere with graphs=False (the eager twin the
    card's checks compare with). graphs=True on the CPU raises.
Admission, the JAX engine's jitted `_prefill`, `_insert` (cache donated) and
`_admit_commit` (slot state donated) and its memoized tail prefill: each
piece is a function of fixed buffers too, into which the host stages what
varies (the padded prompt rows and last indices, the slots and prefill rows
to insert, the group's logits, sampling vectors, lengths and history rows; a
stored prompt's rows and its tail), on the same route and in the same table
as the steps, keyed by ("prefill", bucket, nb), (cache length, "insert",
source, ns), ("commit", group size, custom) and ("extend", entry bucket,
tail bucket, temporary cache length) (`piece(key)` names a key's kind).
Group sizes pad to powers of two as JAX's do: a padded commit row carries
the out-of-range slot index and writes nothing, a padded insert row repeats
the last real one. Growth stays host logic between prefill and insert and
drops the insert graphs of the cache it replaced. A captured prefill writes
its rows, and a captured tail prefill keeps its temporary cache, in one
pair of engine-owned buffers of GRAPH_ROWS rows that every such key views
(JAX's donation frees the same memory after each call): what a key keeps in
the graphs' pool is its last logits. The rows are inserted and sliced, and
the logits copied out, before anything else replays. A prefill of more than
GRAPH_ROWS rows (group x bucket), and its insert, run eagerly on either
route: their launch overhead is a few per cent of their device time, and a
graph would pin their rows.
A horizon's tokens go to pinned host memory without blocking, and the host
waits on a CUDA event recorded after the copy. The JAX engine's
`pipeline_rounds` (round k + 1 dispatched before round k is read) is not
ported: on an H100 its gain stayed inside the host clock's spread.

With BITDISTILLER_QMM_A8=1 the engine serves W{2,4}A8: its weights are
repacked once at construction (after sharding: a rank repacks its own
slice) and every packed matmul quantizes its activations to int8.

Over a (dp, tp) mesh (`mesh=`, `parallel.mesh.make_mesh`) the engine is
one program that every rank of the group runs, as the JAX engine runs
over a sharded mesh. `params` is the rank's slice (`shard_packed_model`
of an unfused packed tree, or `shard_params` of a dense one); the KV cache
is its slice by `kv_cache_specs`: slots over dp (dp rank d holds slots [d
max_slots / dp, (d + 1) max_slots / dp)), kv heads over tp. Every rank
runs the same host loop over the same requests, so every host decision
(admission, growth, the speculative EMA and k, finishing) is taken from
data that is the same on every rank, and every rank meets the same graph
keys in the same order (a first use runs eagerly on every rank together;
a capture issues no operation):
  * an admission group is prefilled on every rank (each tp group runs it
    whole, as JAX's prefill runs replicated over dp), and each rank
    inserts only its own slots' rows; prompt-cache entries are held alike
    on every dp rank, at the rank's kv heads;
  * decode and the speculative verify forward only the rank's slots; the
    tokens are sampled on tp rank 0 and broadcast over the tp group (the
    other tp ranks receive into a buffer of the step's own), and a
    horizon's tokens (and verify counts) are gathered over dp once, for
    its one host read (JAX's `_replicated`), eagerly after the horizon's
    replays; the first tokens of an admission group are sampled on global
    rank 0 and broadcast, inside the commit piece;
  * growth grows the rank's slice;
  * what comes from outside the loop is taken on global rank 0 and
    broadcast each round, outside every piece: the feeder's new requests
    and `stop()` (the other ranks' feeder and stop are not called), and the
    verdicts of `Request.stop_check` (the other ranks receive a request's
    data, not its callbacks: `serve.server.follow` runs such a rank).
A Llama piece at tp > 1 has 2L + 3 operations (the vocab-parallel
embedding's all-reduce, o's and down's in each of L layers, the logits'
all-gather, the token broadcast) in a step or verify round, 2L + 2 in a
prefill or tail prefill, one in a commit (the first tokens' broadcast, at
dp > 1 too) and none in an insert: a chain has one segment more. Under
BITDISTILLER_RING_TP=1 each ring matmul replaces an all-reduce by 3 (tp -
1) operations (`parallel/overlap.py`). A kernel runs between any two
operations, so that no segment is empty.
At `mesh=None`, or dp = tp = 1, nothing of this runs.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .._device import on_card, resolve_device, torch_dtype
from ..models import llama
from ..models.config import ModelConfig
from ..models.llama import KVCache, quantize_kv
from ..ops.decode_attention import flash_decode_stacked
from ..ops.quant_matmul import maybe_repack_a8, qmm_a8, qmm_decode, qmm_prefill
from ..parallel.distributed import boundary, segmented
from ..parallel.tensor import tp_config
from .sampling import SamplingParams, sample_tokens, sample_tokens_batched

# fixed policy, as the JAX engine's defaults: the speculative history window
# (tokens a slot drafts from), the draft lengths the adaptive k chooses
# among (plus spec_k), a verify's cost in plain steps a drafted token, and
# the growth factor between cache buckets
SPEC_HISTORY = 512
SPEC_K_LADDER = (4, 7, 11)
SPEC_STEP_COST = 0.09
CACHE_BUCKET_FACTOR = 2

# the most prefill rows (group x bucket; a tail prefill's temporary cache
# length) an admission piece runs from a graph with: the engine-owned row
# buffers hold that many (`graph_rows_bytes`)
GRAPH_ROWS = 2048
# the kinds of graph key `piece` reads: the steps', the admission's pieces'
STEP_PIECES = ("uniform", "custom", "verify")
ADMISSION_PIECES = ("prefill", "insert", "commit", "extend")

# the launch counters of the wrappers a step can reach: a replay calls no
# wrapper, so the graph table adds what each graph's capture counted
LAUNCH_COUNTERS = ((qmm_decode, "launches"), (qmm_prefill, "launches"), (qmm_a8, "launches"),
                   (qmm_a8, "prefill_launches"), (flash_decode_stacked, "launches"),
                   (flash_decode_stacked, "plain_calls"))


@dataclasses.dataclass
class Request:
    prompt_tokens: list
    max_new_tokens: int = 256
    stream: Optional[Callable[[int], None]] = None  # called with every emitted token
    sampling: Optional[SamplingParams] = None  # per-request override
    stop_token_ids: tuple = ()  # stop ids beyond the engine's eos
    # called once when the request finishes (the HTTP frontend wakes its handler)
    on_finish: Optional[Callable[["Request"], None]] = None
    # called with the output so far after each emitted token; True finishes
    # the request with "stop" (multi-token stop strings)
    stop_check: Optional[Callable[[list], bool]] = None
    # store this prompt's prefill rows in the prompt cache (needs
    # Engine(prompt_cache_size > 0) or prompt_cache_bytes)
    cache_prompt: bool = False
    # filled by the engine:
    output_tokens: list = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str = ""
    prefill_time: float = 0.0
    decode_tokens: int = 0
    decode_time: float = 0.0


_WIRE = ("prompt_tokens", "max_new_tokens", "sampling", "stop_token_ids", "cache_prompt")


def _wire(req: Request) -> dict:
    """A request's data as global rank 0 broadcasts it to a mesh's other
    ranks: no callback crosses (`stop_check` only as a flag; its verdicts
    follow each round)."""
    return dict({k: getattr(req, k) for k in _WIRE}, stop_check=req.stop_check is not None)


def _rank0_verdict(output_tokens: list) -> bool:
    raise AssertionError("a mesh rank other than 0 reads rank 0's stop_check verdicts")


def _unwire(data: dict) -> Request:
    req = Request(**{k: data[k] for k in _WIRE})
    if data["stop_check"]:
        req.stop_check = _rank0_verdict
    return req


def _buckets(max_len: int, lo: int = 64, factor: int = 2):
    out, b = [], lo
    while b < max_len:
        out.append(b)
        b *= factor
    out.append(max_len)
    return out


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def grow_kv_cache(cache: KVCache, new_len: int) -> KVCache:
    """A cache of `new_len` rows holding `cache`'s rows at the front and
    zeros after them (the T axis of [L, B, H, T, D] and of the int8 scale
    planes [L, B, H, T])."""

    def one(buf):
        if buf is None:
            return None
        shape = list(buf.shape)
        old, shape[3] = shape[3], new_len
        out = torch.zeros(shape, dtype=buf.dtype, device=buf.device)
        out[:, :, :, :old] = buf
        return out

    return KVCache(k=one(cache.k), v=one(cache.v), k_scale=one(cache.k_scale),
                   v_scale=one(cache.v_scale))


def piece(key: tuple) -> str:
    """A graph key's kind: one of STEP_PIECES or ADMISSION_PIECES."""
    return key[0] if isinstance(key[0], str) else key[1]


def graph_rows_bytes(cfg: ModelConfig, tp: int = 1) -> int:
    """Bytes of the engine-owned rows a captured prefill writes (k and v,
    GRAPH_ROWS rows of every layer at the rank's kv heads, in the model's
    dtype): what the graph route holds beyond the cache, the weights and the
    graphs' pool."""
    itemsize = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    return (2 * cfg.num_layers * GRAPH_ROWS * (cfg.num_kv_heads // tp) * cfg.actual_head_dim
            * itemsize)


class _Fetch:
    """Device tensors on their way to the host. On the card each is copied
    into pinned host memory without blocking and an event is recorded after
    the copies: `wait` blocks on that event, so work queued after the copy
    (the horizon dispatched after an admission's first tokens) is on the
    card before the host blocks. On the CPU the tensors are read as they
    are."""

    def __init__(self, tensors):
        self.event = None
        if tensors and on_card(tensors[0]):
            self.host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for h, t in zip(self.host, tensors):
                h.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = list(tensors)

    def wait(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.host]


class _GraphTable:
    """Captured graphs (on the card a `_Chain` each) by key, (cache length,
    mode...) or (piece, shape...).
    A key's first use runs the body eagerly, so that what the kernels make
    at first use (kmap tables, the TMA encoder, cluster checks, cuBLAS
    workspaces) exists before the capture, and then captures it; every
    later use replays the graph. A body either writes the engine's buffers
    (returns None) or returns a tuple of tensors: the captured ones are the
    graph's outputs, which every replay rewrites in place and `run` returns
    (at the first use, holding the eager run's values). A capture launches
    nothing, so the launch counters are set back after it, and each replay
    adds the deltas the capture recorded. `new_graph()` and
    `capture(graph, body)` (which returns the body's outputs) are `_Chain`
    and `_cuda_capture`'s on the card. `replay_s`: the host seconds of the
    replays (under a mesh the operations between segments included:
    `distributed.BOUNDARY_STATS` counts those)."""

    def __init__(self, new_graph, capture, counters=LAUNCH_COUNTERS):
        self.new_graph, self.capture, self.counters = new_graph, capture, counters
        self.graphs: dict = {}  # key -> (graph, counter deltas, outputs)
        self.captured: list = []  # every key captured, in order
        self.capture_s = 0.0
        self.replay_s = 0.0
        self.replays = 0
        self.replayed: collections.Counter = collections.Counter()  # replays by key

    def run(self, key, body):
        entry = self.graphs.get(key)
        if entry is not None:
            graph, deltas, outs = entry
            t0 = time.perf_counter()
            graph.replay()
            self.replay_s += time.perf_counter() - t0
            self.replays += 1
            self.replayed[key] += 1
            for (obj, attr), d in zip(self.counters, deltas):
                if d:
                    setattr(obj, attr, getattr(obj, attr) + d)
            return outs
        first = body()
        before = [getattr(obj, attr) for obj, attr in self.counters]
        graph = self.new_graph()
        t0 = time.perf_counter()
        outs = self.capture(graph, body)
        self.capture_s += time.perf_counter() - t0
        deltas = tuple(getattr(obj, attr) - b for (obj, attr), b in zip(self.counters, before))
        for (obj, attr), b in zip(self.counters, before):
            setattr(obj, attr, b)
        if outs is not None:  # later uses read the graph's outputs: give them the eager values
            for dst, src in zip(outs, first):
                dst.copy_(src)
        self.graphs[key] = (graph, deltas, outs)
        self.captured.append(key)
        return outs

    def count(self, pieces) -> tuple:
        """(keys captured, replays) of the keys whose kind is in `pieces`."""
        return (sum(piece(k) in pieces for k in self.captured),
                sum(n for k, n in self.replayed.items() if piece(k) in pieces))

    def drop(self, cache_len: int) -> None:
        """Forget the graphs of a cache that growth replaced."""
        for key in [k for k in self.graphs if k[0] == cache_len]:
            del self.graphs[key]

    def segments(self) -> dict:
        """{key: segments} of the chains held."""
        return {k: g.segments for k, (g, _, _) in self.graphs.items()}


class _Chain:
    """One key's capture: its segments, one graph each, split at the
    piece's collective and point-to-point operations, and those operations
    (`distributed.Boundary`) between them, in order. `replay()` runs them
    in that order on the current stream, the operations eagerly. A piece
    without an operation (every piece at mesh=None) is one segment."""

    def __init__(self):
        self.steps: list = []  # ("graph", segment) | ("op", Boundary)

    @property
    def segments(self) -> int:
        return sum(kind == "graph" for kind, _ in self.steps)

    def replay(self) -> None:
        for kind, x in self.steps:
            if kind == "graph":
                x.replay()
            else:
                x.run(replayed=True)


_CAPTURE_STREAM: list = []  # the one side stream every capture runs on


def _cuda_capture(generator: torch.Generator):
    """capture(chain, body) on the card: the body recorded into `chain` by
    `distributed.segmented`, each segment a CUDA graph captured on one side
    stream in the engine's one memory pool (`capture.pool`; a key's segments
    replay back to back, and what a piece returns is read before another
    piece replays), with the engine's generator registered in each, so that
    a replay draws what the eager piece would at the same generator state.
    The device is synchronized and the cache emptied once a key, not once a
    segment; an operation's tensors come from the pool, allocated by the
    segment before it, and its chain holds them as `distributed.unowned`
    views, so that the pool reuses them for every other key as it reuses a
    graph's transients (holding them would keep 2L + 1 f32 buffers of a
    prefill's rows x hidden for each key)."""
    pool = torch.cuda.graph_pool_handle()

    def begin():
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(generator)
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        return graph

    def capture(chain, body):
        if not _CAPTURE_STREAM:
            _CAPTURE_STREAM.append(torch.cuda.Stream())
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        with torch.cuda.stream(_CAPTURE_STREAM[0]):
            chain.steps, outs = segmented(body, begin, lambda graph: graph.capture_end())
        return outs

    capture.pool = pool
    return capture


def _set_rows(buf: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> None:
    """buf[idx[i]] = vals[i] in place; an index of len(buf) writes nothing
    (JAX's scatter with mode="drop", through a spare row)."""
    ext = torch.cat([buf, buf[:1]])
    ext.index_copy_(0, idx, vals.to(buf.dtype))
    buf.copy_(ext[:-1])


class Engine:
    def __init__(
        self,
        params,
        cfg: ModelConfig,
        *,
        max_slots: int = 8,
        max_len: int = 2048,
        sampling: SamplingParams = SamplingParams(),
        eos_token_id: Optional[int] = 2,
        cache_dtype=torch.bfloat16,
        rep_window: int = 128,
        seed: int = 0,
        decode_horizon: int = 8,
        grow_cache: bool = True,
        prompt_cache_size: int = 0,
        prompt_cache_bytes: Optional[int] = None,
        spec_decode: bool = False,
        spec_k: int = 4,
        spec_ngram: int = 2,
        spec_adaptive_k: bool = True,
        spec_ngram_backoff: bool = False,
        device="cuda",
        mesh=None,
        graphs: Optional[bool] = None,
    ):
        self.device = resolve_device(device)
        # the rank's slots [slot0, slot0 + local_slots) of a mesh's dp split
        self.mesh = mesh if mesh is not None and (mesh.dp > 1 or mesh.tp > 1) else None
        if graphs and self.device.type != "cuda":
            raise ValueError(f"graphs=True on {self.device}: CUDA graphs need the card")
        if graphs is None:
            graphs = self.device.type == "cuda"
        local = max_slots
        cache_cfg = cfg
        if self.mesh is not None:
            if max_slots % mesh.dp:
                raise ValueError(f"max_slots = {max_slots} is not a multiple of dp = {mesh.dp}: "
                                 f"each dp rank holds max_slots / dp slots")
            local = max_slots // mesh.dp
            cache_cfg = tp_config(cfg, mesh.tp)
        self.local_slots = local
        self.slot0 = 0 if self.mesh is None else mesh.dp_rank * local
        # BITDISTILLER_QMM_A8=1: every packed leaf is repacked once into the
        # A8 kernel's byte order (as the JAX engine does at load)
        self.params = maybe_repack_a8(params)
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.sampling = sampling
        self.eos = eos_token_id
        self.horizon = max(decode_horizon, 1)
        self.buckets = _buckets(max_len)
        # finer ladder for tail-only prefills (a chat turn is often short)
        self.tail_buckets = _buckets(max_len, lo=16)
        self.grow_cache = grow_cache
        self.cache_buckets = _buckets(max_len, factor=CACHE_BUCKET_FACTOR)
        dev = self.device
        first_len = self.cache_buckets[0] if grow_cache else max_len
        self.cache_cfg = cache_cfg  # the rank's: its kv heads
        self.cache = KVCache.init(cache_cfg, local, first_len, cache_dtype, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        # the steps' and the admission's route: "graphs" (replayed from
        # `_graphs`) or "eager"
        self.route = "graphs" if graphs else "eager"
        self._graphs = _GraphTable(_Chain, _cuda_capture(self.generator)) if graphs else None
        self._staged: dict = {}  # (name, shape, dtype) -> an admission's fixed input buffer
        # a captured prefill's rows, a captured tail prefill's temporary
        # cache: (k, v) flat, GRAPH_ROWS rows, made at the first such piece
        self._rows: Optional[tuple] = None
        # the prefill's start on the device: a Python 0 would be copied from
        # the host inside the captured forward
        self._zero_pos = torch.zeros((), dtype=torch.int64, device=dev)

        # prompt cache: tuple(prompt) -> (KV [L, 1, Pb, H, D] in the prefill
        # layout and dtype, last logits [V], prompt length). A byte budget
        # alone also enables it, with an entry cap that keeps admission's
        # prefix scan short.
        if prompt_cache_bytes is not None and prompt_cache_size == 0:
            prompt_cache_size = 512
        self.prompt_cache_size = prompt_cache_size
        self.prompt_cache_bytes = prompt_cache_bytes
        self._prompt_cache: collections.OrderedDict = collections.OrderedDict()
        self.prompt_cache_hits = 0
        self.prompt_cache_prefix_hits = 0
        self.prompt_cache_misses = 0

        # n-gram speculative decoding; acceptance below spec_min_accept
        # tokens a verify cell dispatches the plain step, with a one-round
        # probe every spec_retry_every rounds
        self.spec_decode = spec_decode
        self.spec_k = spec_k
        self.spec_ngram = spec_ngram
        self.spec_ngram_backoff = spec_ngram_backoff
        self.spec_min_accept = 1.3
        self.spec_retry_every = 16
        self._spec_ema: Optional[float] = None
        self._spec_last_rate = 0.0  # the last horizon's measured acceptance
        self._spec_off_rounds = 0
        self.spec_adaptive_k = spec_adaptive_k
        self.spec_k_ladder = tuple(sorted(set(SPEC_K_LADDER + (spec_k,))))
        self._spec_k_cur = spec_k  # the current adaptive choice
        self._spec_k_last = spec_k  # the k the last EMA update was measured at
        self.spec_rounds = 0  # (round, active-slot) verify cells fetched
        self.spec_tokens = 0  # tokens those cells produced (<= k + 1 each)

        # device-side slot state of the rank's slots: advanced by decode
        # without host syncs, allocated once and written only in place (a
        # captured step reads and writes these addresses)
        self.prev_tokens = torch.full((local, rep_window), -1, dtype=torch.int32, device=dev)
        self.history = torch.full((local, SPEC_HISTORY), -2, dtype=torch.int32, device=dev)
        self.cur_tokens = torch.zeros(local, dtype=torch.int32, device=dev)
        self._lengths_dev = torch.zeros(local, dtype=torch.int32, device=dev)
        self._active_dev = torch.zeros(local, dtype=torch.bool, device=dev)
        self._temps = torch.full((local,), sampling.temperature, dtype=torch.float32, device=dev)
        self._top_ks = torch.full((local,), sampling.top_k, dtype=torch.int32, device=dev)
        self._top_ps = torch.full((local,), sampling.top_p, dtype=torch.float32, device=dev)
        self._rep_pens = torch.full((local,), sampling.repetition_penalty,
                                    dtype=torch.float32, device=dev)
        # a horizon: the positions its plain steps are at, its step index and
        # its output rows (row h: step h's tokens; a verify's per k, with the
        # counts)
        self._pos = torch.zeros(local, dtype=torch.int32, device=dev)
        self._hz_step = torch.zeros(1, dtype=torch.int64, device=dev)
        self._hz_tokens = torch.zeros((self.horizon, local), dtype=torch.int32, device=dev)
        self._hz_verify: dict = {}  # k -> (tokens [H, B, k + 1], counts [H, B])
        # host-side slot state; _len_ub upper-bounds every active slot's cache
        # position (a verify round counts k + 1 rows), so a dispatch knows
        # without a sync when the cache must grow
        self.slot_req: list[Optional[Request]] = [None] * max_slots
        self.lengths = np.zeros(max_slots, np.int32)
        self._len_ub = np.zeros(max_slots, np.int64)
        self.active = np.zeros(max_slots, bool)
        self._slot_custom = np.zeros(max_slots, bool)
        self._active_dirty = True
        # what ran, for the launch counts a caller predicts
        self.decode_steps = 0  # plain decode forwards (each advances every slot)
        self.decode_steps_at: collections.Counter = collections.Counter()  # by cache length
        self.spec_forwards: collections.Counter = collections.Counter()  # verify forwards by k
        self.prefills = 0  # batched prefill forwards
        self.prefix_extends: list = []  # tail bucket of each tail-only prefill forward
        self.growths: list = []  # (old, new) cache lengths of each growth copy
        # a mesh's stop_check verdicts: rank 0's firings this round ({slot:
        # output length}); the other ranks' copy of them
        self._stops_fired: dict = {}
        self._stop_at: Optional[dict] = None

    # -- the mesh's slots and broadcasts ---------------------------------------

    def _lead(self) -> bool:
        """True on the rank that takes outside decisions: global rank 0, or
        the only one."""
        return self.mesh is None or dist.get_rank() == 0

    def _mine(self, slot: int) -> bool:
        return self.slot0 <= slot < self.slot0 + self.local_slots

    def _taken_once(self, sample, shape, over_tp: bool) -> torch.Tensor:
        """`sample()` (int32 tokens) taken on one rank and broadcast: tp rank
        0 over the tp group (`over_tp`: every tp rank feeds the same tokens
        on), else global rank 0 to every rank."""
        m = self.mesh
        if m is None or (over_tp and m.tp == 1):
            return sample()
        src, group = (m.dp_rank * m.tp, m.tp_group) if over_tp else (0, None)
        out = (sample().contiguous() if dist.get_rank() == src
               else torch.empty(shape, dtype=torch.int32, device=self.device))
        boundary("broadcast", lambda r, w: dist.broadcast(w[0], src=src, group=group), group,
                 reads=(out,), writes=(out,))
        return out

    def _all_slots(self, t: torch.Tensor) -> torch.Tensor:
        """A horizon's [steps, local slots, ...] tensor gathered over dp into
        [steps, max_slots, ...] (slot order = dp rank order)."""
        if self.mesh is None or self.mesh.dp == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.mesh.dp)]
        dist.all_gather(parts, t, group=self.mesh.dp_group)
        return torch.cat(parts, dim=1)

    # -- device pieces ------------------------------------------------------

    def _buf(self, name: str, shape: tuple, dtype) -> torch.Tensor:
        """An admission's input buffer, allocated once by (name, shape,
        dtype): the host stages into it, and a captured piece reads its
        address."""
        key = (name, tuple(shape), dtype)
        buf = self._staged.get(key)
        if buf is None:
            buf = self._staged[key] = torch.zeros(shape, dtype=dtype, device=self.device)
        return buf

    def _run(self, key: tuple, body):
        """One step or admission piece on the engine's route: `body()`
        eagerly, or the graph of `key`."""
        if self._graphs is None:
            return body()
        return self._graphs.run(key, body)

    def _step(self, key: tuple, body) -> None:
        """One decode step: the graph of (cache length,) + key."""
        self._run((self._cache_len(),) + key, body)

    def _row_views(self, rows: int, shape: tuple) -> Optional[tuple]:
        """(k, v) views of `shape` over the first `rows` of the engine-owned
        row buffers, or None where the piece runs eagerly: on the eager
        route, and past GRAPH_ROWS rows."""
        if self._graphs is None or rows > GRAPH_ROWS:
            return None
        if self._rows is None:
            cfg = self.cache_cfg
            n = GRAPH_ROWS * cfg.num_layers * cfg.num_kv_heads * cfg.actual_head_dim
            self._rows = tuple(torch.zeros(n, dtype=torch_dtype(cfg.dtype), device=self.device)
                               for _ in range(2))
        n = int(np.prod(shape))
        return tuple(b[:n].view(shape) for b in self._rows)

    def _stage_kv(self, kv: KVCache) -> KVCache:
        """A stored prompt's rows [L, 1, P, H, D] copied into the fixed
        buffer of their shape, which a hit's insert and a tail prefill read."""
        k = self._buf("stage_k", kv.k.shape, kv.k.dtype)
        v = self._buf("stage_v", kv.v.shape, kv.v.dtype)
        k.copy_(kv.k)
        v.copy_(kv.v)
        return KVCache(k=k, v=v)

    @torch.inference_mode()
    def _prefill(self, padded: np.ndarray, last_idx: np.ndarray):
        """[nb, S] prompts -> (last-position logits [nb, V], KV [L, nb, S, H,
        D], the insert's source: None where the KV is not at a fixed
        address). The rows are staged into the (S, nb) buffers; on the graph
        route, up to GRAPH_ROWS rows, the key's graph writes the KV into the
        engine-owned rows and returns the logits, read before another piece
        replays."""
        nb, s = padded.shape
        tokens = self._buf("prefill_tokens", (nb, s), torch.int64)
        last = self._buf("prefill_last", (nb,), torch.int64)
        tokens.copy_(torch.from_numpy(padded))
        last.copy_(torch.from_numpy(last_idx))
        self.prefills += 1
        cfg = self.cache_cfg
        out = self._row_views(nb * s, (cfg.num_layers, nb, s, cfg.num_kv_heads,
                                       cfg.actual_head_dim))
        if out is None:
            logits, k, v = self._prefill_body(tokens, last, None)
            return logits, KVCache(k=k, v=v), None
        kv = KVCache(k=out[0], v=out[1])
        (logits,) = self._run(("prefill", s, nb),
                              lambda: self._prefill_body(tokens, last, kv)[:1])
        return logits, kv, ("prefill", s, nb)

    def _prefill_body(self, tokens: torch.Tensor, last_idx: torch.Tensor, kv_out) -> tuple:
        logits, kv = llama.forward(self.params, self.cfg, tokens, cache_pos=self._zero_pos,
                                   return_kv=True, kv_out=kv_out, mesh=self.mesh)
        v = logits.shape[-1]
        last = logits.gather(1, last_idx[:, None, None].expand(-1, 1, v))[:, 0]
        return last, kv.k, kv.v

    @torch.inference_mode()
    def _insert(self, kv: KVCache, source: Optional[tuple], slots: list, rows: list) -> None:
        """Write prefill rows [0, S) into the slots' cache planes, transposed
        to head-major [L, H, S, D] (quantized for an int8 cache); on a mesh
        only the rank's own slots. Rows past a prompt's length hold padding
        and stay masked by the slot's position (t < cache_pos). `source`
        names kv's fixed buffer (a prefill key's rows, or the staging of a
        stored prompt) in the piece's key: (cache length, "insert") + source
        + (ns,), the (slot, row) pairs padded to ns by repeating the last pair
        (the same bytes to the same rows again, which leaves the cache as if
        the padding wrote nothing): the group's size padded to a power of
        two, at most the rank's slots, so that on a mesh's dp ranks the key
        follows the group, not how many of its slots are the rank's (as
        JAX's insert has the group's shape). None (kv at no fixed address)
        runs it eagerly."""
        pairs = [(slot - self.slot0, row) for slot, row in zip(slots, rows) if self._mine(slot)]
        if not pairs:
            return
        ns = min(_pow2_at_least(len(slots)), self.local_slots)
        pairs += [pairs[-1]] * (ns - len(pairs))
        idx = self._buf("insert_rows", (2, ns), torch.int64)
        idx.copy_(torch.as_tensor(pairs, dtype=torch.int64).T)
        body = functools.partial(self._insert_body, kv, idx)
        if source is None:
            body()
        else:
            self._run((self._cache_len(), "insert") + source + (ns,), body)

    def _insert_body(self, kv: KVCache, idx: torch.Tensor) -> None:
        slots, rows = idx[0], idx[1]
        nk = kv.k.permute(0, 1, 3, 2, 4)  # [L, nb, H, S, D]
        nv = kv.v.permute(0, 1, 3, 2, 4)
        s = nk.shape[3]
        c = self.cache
        if c.quantized:
            nk, ks = quantize_kv(nk)
            nv, vs = quantize_kv(nv)
            c.k_scale[:, :, :, :s].index_copy_(1, slots, ks.index_select(1, rows))
            c.v_scale[:, :, :, :s].index_copy_(1, slots, vs.index_select(1, rows))
        c.k[:, :, :, :s].index_copy_(1, slots, nk.index_select(1, rows).to(c.k.dtype))
        c.v[:, :, :, :s].index_copy_(1, slots, nv.index_select(1, rows).to(c.v.dtype))

    def _check_steps(self, steps: int) -> None:
        if not 1 <= steps <= self.horizon:
            raise ValueError(f"a horizon of {steps} steps: the engine's output rows hold "
                             f"1 to decode_horizon = {self.horizon}")

    def _plain_step(self, custom: bool) -> None:
        """One decode step of every slot of the rank, on the engine's
        buffers: the token in `cur_tokens` at `_pos`, the sampled token
        (0 for an inactive slot) into `cur_tokens`, `prev_tokens` and the
        horizon's row `_hz_step`. Inactive slots decode masked junk into
        their own rows."""
        logits, _ = llama.forward(self.params, self.cfg, self.cur_tokens[:, None],
                                  cache=self.cache, cache_pos=self._pos, mesh=self.mesh)
        if custom:
            sample = lambda: sample_tokens_batched(
                logits[:, 0], self._temps, self._top_ks, self._top_ps, self._rep_pens,
                self.prev_tokens, generator=self.generator)
        else:
            sample = lambda: sample_tokens(logits[:, 0], self.sampling, self.prev_tokens,
                                           generator=self.generator)
        nxt = torch.where(self._active_dev,
                          self._taken_once(sample, (self.local_slots,), over_tp=True), 0)
        self.prev_tokens.copy_(torch.cat([self.prev_tokens[:, 1:], nxt[:, None]], dim=1))
        self._pos.copy_(torch.clamp(self._pos + 1, max=self.max_len - 1))
        self._lengths_dev.add_(self._active_dev.to(torch.int32))
        self.cur_tokens.copy_(nxt)
        self._hz_tokens.index_copy_(0, self._hz_step, nxt[None])
        self._hz_step.add_(1)

    @torch.inference_mode()
    def _decode(self, steps: int, custom: bool) -> torch.Tensor:
        """`steps` decode steps for every slot of the rank; returns tokens
        [steps, local slots] on the device (the horizon's output rows)."""
        self._check_steps(steps)
        self.decode_steps += steps
        self.decode_steps_at[self._cache_len()] += steps
        self._pos.copy_(self._lengths_dev)
        self._hz_step.zero_()
        body = functools.partial(self._plain_step, custom)
        for _ in range(steps):
            self._step(("custom" if custom else "uniform",), body)
        return self._hz_tokens[:steps]

    @staticmethod
    def ngram_draft(hist: torch.Tensor, k: int, ngram: int) -> torch.Tensor:
        """Draft k tokens a row: the tokens that followed the LAST earlier
        occurrence of the trailing `ngram`-gram in the right-aligned history
        window (-1 where there is none or the context is filler: a -1 draft
        never equals a sampled token)."""
        b, hw = hist.shape
        ctx = hist[:, hw - ngram:]  # [B, ngram]
        m = torch.ones((b, hw - ngram), dtype=torch.bool, device=hist.device)
        for i in range(ngram):  # gram starts o in [0, hw - ngram)
            m = m & (hist[:, i:i + hw - ngram] == ctx[:, i:i + 1])
        starts = torch.arange(hw - ngram, device=hist.device)
        ostar = torch.where(m, starts[None, :], -1).amax(dim=1)  # [B]
        have_ctx = ctx.amin(dim=1) >= 0
        idx = torch.clamp(ostar[:, None] + ngram + torch.arange(k, device=hist.device)[None, :],
                          0, hw - 1)
        d = hist.gather(1, idx)  # [B, k]
        ok = (ostar >= 0) & have_ctx
        return torch.where(ok[:, None] & (d >= 0), d, -1)

    @staticmethod
    def ngram_draft_backoff(hist: torch.Tensor, k: int, hi: int, lo: int) -> torch.Tensor:
        """Rows whose trailing `hi`-gram has an earlier match take that
        draft; the others fall back to the `lo`-gram draft."""
        dh = Engine.ngram_draft(hist, k, hi)
        dl = Engine.ngram_draft(hist, k, lo)
        return torch.where(dh[:, :1] >= 0, dh, dl)

    @staticmethod
    def _var_append(buf: torch.Tensor, toks: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        """Append the first n[b] of toks[b] to the right-aligned window
        buf[b] (a per-row shift through a gather)."""
        w = buf.shape[1]
        ext = torch.cat([buf, toks.to(buf.dtype)], dim=1)  # [B, W + K]
        idx = n.to(torch.int64)[:, None] + torch.arange(w, device=buf.device)[None, :]
        return ext.gather(1, idx)

    def _verify_step(self, k: int, toks: torch.Tensor, counts: torch.Tensor) -> None:
        """One verify round on the engine's buffers: draft k tokens from each
        slot's `history`, verify them in one S = k + 1 forward at the slots'
        lengths, accept the longest sampled == draft prefix plus the next
        sampled token; the sampled tokens and the counts into the horizon's
        row `_hz_step` of `toks` [H, B, k + 1] and `counts` [H, B]."""
        max_pos = self.max_len - 1
        prev, hist, active = self.prev_tokens, self.history, self._active_dev
        if self.spec_ngram_backoff:
            draft = self.ngram_draft_backoff(hist, k, self.spec_ngram + 1, self.spec_ngram)
        else:
            draft = self.ngram_draft(hist, k, self.spec_ngram)
        tokens_in = torch.cat([self.cur_tokens[:, None], draft], dim=1)
        # the forward reads cache rows < the length and the fresh S tokens
        # causally; -1 drafts run as 0 and are never accepted
        logits, _ = llama.forward(self.params, self.cfg, torch.clamp(tokens_in, min=0),
                                  cache=self.cache, cache_pos=self._lengths_dev, mesh=self.mesh)
        b, s, v = logits.shape
        # all k + 1 positions share the round-start penalty window (exact at
        # repetition_penalty 1.0, which _spec_active requires)
        sampled = self._taken_once(
            lambda: sample_tokens(logits.reshape(b * s, v), self.sampling,
                                  prev[:, None].expand(b, s, prev.shape[1]).reshape(b * s, -1),
                                  generator=self.generator).reshape(b, s), (b, s),
            over_tp=True)
        good = (sampled[:, :k] == draft).to(torch.int32)
        acc = torch.cumprod(good, dim=1).sum(dim=1)  # [B] in [0, k]
        n_new = torch.where(active, acc + 1, 0).to(torch.int32)
        cur = torch.where(active, sampled.gather(1, acc[:, None])[:, 0], 0)
        pos = torch.clamp(self._lengths_dev + n_new, max=max_pos)
        new_prev = self._var_append(prev, sampled, n_new)
        new_hist = self._var_append(hist, sampled, n_new)
        self.cur_tokens.copy_(cur)
        self._lengths_dev.copy_(pos)
        self.prev_tokens.copy_(new_prev)
        self.history.copy_(new_hist)
        toks.index_copy_(0, self._hz_step, sampled[None])
        counts.index_copy_(0, self._hz_step, n_new[None])
        self._hz_step.add_(1)

    @torch.inference_mode()
    def _spec_decode(self, steps: int, k: int):
        """`steps` verify rounds at draft length k. Returns tokens [steps, B,
        k + 1] and the valid counts [steps, B] on the device (B: the rank's
        slots; the horizon's output rows of k)."""
        self._check_steps(steps)
        self.spec_forwards[k] += steps
        if k not in self._hz_verify:
            self._hz_verify[k] = (
                torch.zeros((self.horizon, self.local_slots, k + 1), dtype=torch.int32,
                            device=self.device),
                torch.zeros((self.horizon, self.local_slots), dtype=torch.int32,
                            device=self.device))
        toks, counts = self._hz_verify[k]
        self._hz_step.zero_()
        body = functools.partial(self._verify_step, k, toks, counts)
        for _ in range(steps):
            self._step(("verify", k), body)
        return toks[:steps], counts[:steps]

    # -- host scheduling ----------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i in range(self.max_slots):
            if not self.active[i]:
                return i
        return None

    @staticmethod
    def _entry_bytes(entry) -> int:
        kv, last = entry[0], entry[1]
        return kv.k.nbytes + kv.v.nbytes + last.nbytes

    def _prompt_cache_put(self, key, entry) -> None:
        """Insert, then evict least recently used entries past the entry
        cap and past the byte budget."""
        self._prompt_cache[key] = entry
        self._prompt_cache.move_to_end(key)
        while len(self._prompt_cache) > self.prompt_cache_size:
            self._prompt_cache.popitem(last=False)
        if self.prompt_cache_bytes is None:
            return
        total = sum(self._entry_bytes(e) for e in self._prompt_cache.values())
        while total > self.prompt_cache_bytes and self._prompt_cache:
            _, ev = self._prompt_cache.popitem(last=False)
            total -= self._entry_bytes(ev)

    @staticmethod
    def _slice_entry(kv: KVCache, last_logits: torch.Tensor, row: int, pb: int):
        """One prefill row cut to its own length bucket, as a prompt cache
        entry's (KV [L, 1, pb, H, D], last logits [V]). It stays eager on
        every route: the slice is the copy that takes the row out of the
        prefill's rows (on the graph route the engine-owned ones, which the
        next prefill overwrites), which a captured slice would have to
        repeat."""
        return (KVCache(k=kv.k[:, row:row + 1, :pb].clone(), v=kv.v[:, row:row + 1, :pb].clone()),
                last_logits[row].clone())

    @torch.inference_mode()
    def _extend_prefix(self, ekv: KVCache, pfx_len: int, tail: list):
        """Tail-only prefill of a prompt whose first `pfx_len` tokens are
        cached: a one-row temporary cache holds the stored rows, one forward
        runs the tail (padded to its tail bucket) against it, and the
        combined rows come back in the prefill layout with the tail's last
        logits: the form of an exact-hit entry. The stored rows, the tail,
        its start and its last index are staged into fixed buffers; the
        piece's key is (entry bucket, tail bucket, temporary cache length),
        as JAX memoizes its jit. On the graph route (a temporary cache of up
        to GRAPH_ROWS rows) that cache is the engine-owned rows, and the
        results are copied out of them and of the graph's pool at once."""
        tail_len = len(tail)
        tb = next(b for b in self.tail_buckets if b >= tail_len)
        # the temporary cache covers the prefix plus the PADDED tail: the
        # forward's write of S rows starts at min(pos, T - S), so a shorter
        # cache would move the tail's rows over the prefix
        tc_len = next((b for b in self.buckets if b >= pfx_len + tb), self.max_len)
        self.prefix_extends.append(tb)
        stage = self._stage_kv(ekv)
        tokens = self._buf("extend_tail", (1, tb), torch.int64)
        start = self._buf("extend_start", (1,), torch.int32)
        last = self._buf("extend_last", (1,), torch.int64)
        padded = torch.zeros((1, tb), dtype=torch.int64)
        padded[0, :tail_len] = torch.as_tensor(tail, dtype=torch.int64)
        tokens.copy_(padded)
        start.fill_(pfx_len)
        last.fill_(tail_len - 1)
        L, _, pb, h, d = ekv.k.shape
        shape = (L, 1, h, tc_len, d)
        temp = self._row_views(tc_len, shape)
        if temp is None:
            temp = tuple(torch.empty(shape, dtype=ekv.k.dtype, device=ekv.k.device)
                         for _ in range(2))
            (logits,) = self._extend_body(stage, tokens, start, last, temp)
        else:
            (logits,) = self._run(("extend", pb, tb, tc_len), functools.partial(
                self._extend_body, stage, tokens, start, last, temp))
        k, v = (t.permute(0, 1, 3, 2, 4).clone() for t in temp)
        return (KVCache(k=k, v=v), logits.clone(), pfx_len + tail_len)

    def _extend_body(self, ekv: KVCache, tokens, start, last_idx, temp: tuple) -> tuple:
        """The tail's forward over the temporary cache `temp` (k, v [L, 1,
        H, T, D]), zeroed and then holding the stored rows; returns the
        tail's last logits (1-tuple)."""
        pb = ekv.k.shape[2]
        cache = KVCache(k=temp[0], v=temp[1])
        for t, rows in zip(temp, (ekv.k, ekv.v)):
            t.zero_()
            t[:, :, :, :pb] = rows.permute(0, 1, 3, 2, 4)
        logits, _ = llama.forward(self.params, self.cfg, tokens, cache=cache, cache_pos=start,
                                  mesh=self.mesh)
        return (logits[0].index_select(0, last_idx)[0],)

    def _lookup(self, reqs: list, keys: list) -> dict:
        """Prompt cache hits of an admission group: {request index: (KV,
        last logits, length)}, exact hits and longest proper prefixes (the
        latter extended by a tail-only prefill)."""
        hits: dict = {}
        # longest first: the first prefix match is the longest
        cands = sorted(self._prompt_cache, key=len, reverse=True)
        for i, k in enumerate(keys):
            e = self._prompt_cache.get(k)
            if e is not None:
                self._prompt_cache.move_to_end(k)
                hits[i] = e
                continue
            best = next((ck for ck in cands if len(ck) < len(k) and k[:len(ck)] == ck), None)
            if best is None:
                continue
            ekv, _, pl = self._prompt_cache[best]
            tb = next(b for b in self.tail_buckets if b >= len(k) - pl)
            if pl + tb > self.max_len:
                continue  # the padded tail would not fit: full prefill
            self._prompt_cache.move_to_end(best)
            hits[i] = self._extend_prefix(ekv, pl, list(k[pl:]))
            self.prompt_cache_prefix_hits += 1
            if reqs[i].cache_prompt:
                self._prompt_cache_put(k, hits[i])
        self.prompt_cache_hits += len(hits)
        self.prompt_cache_misses += len(keys) - len(hits)
        return hits

    @torch.inference_mode()
    def _admit_group(self, reqs: list, slots: list) -> torch.Tensor:
        """Prefill the group's missing unique prompts in one batched call,
        insert every request's rows into its slot (prompt cache hits from
        their stored rows) and sample its first token (on the device;
        returned unsynced)."""
        t0 = time.time()
        n = len(reqs)
        # truncate from the left so the cache never overflows
        plens = [min(len(r.prompt_tokens), self.max_len - 1) for r in reqs]
        keys = [tuple(r.prompt_tokens[-pl:]) for r, pl in zip(reqs, plens)]
        hits = self._lookup(reqs, keys) if self.prompt_cache_size else {}

        # one prefill row per UNIQUE missing prompt
        uniq: dict = {}
        row_of: dict = {}
        for i, k in enumerate(keys):
            if i not in hits:
                row_of[i] = uniq.setdefault(k, len(uniq))
        miss_last = None
        if uniq:
            bucket = next(b for b in self.buckets if b >= max(len(k) for k in uniq))
            nb = min(_pow2_at_least(len(uniq)), self.max_slots)  # bounded batch shapes
            padded = np.zeros((nb, bucket), np.int64)
            last_idx = np.zeros(nb, np.int64)
            for k, row in uniq.items():
                padded[row, :len(k)] = k
                last_idx[row] = len(k) - 1
            miss_last, kv, source = self._prefill(padded, last_idx)
            miss_last = miss_last.clone()  # out of the graph pool before another replay
            self._ensure_cache(bucket)  # the prefill rows must fit the buffer
            self._insert(kv, source, [slots[i] for i in row_of], list(row_of.values()))
            if self.prompt_cache_size:
                for i in row_of:
                    if reqs[i].cache_prompt and keys[i] not in self._prompt_cache:
                        pb = next(b for b in self.buckets if b >= plens[i])
                        self._prompt_cache_put(
                            keys[i], self._slice_entry(kv, miss_last, row_of[i], pb) + (plens[i],))
            del kv
        for i, (ekv, _, _) in hits.items():
            self._ensure_cache(ekv.k.shape[2])
            self._insert(self._stage_kv(ekv), ("stage",) + tuple(ekv.k.shape[1:3]), [slots[i]],
                         [0])
        last_logits = torch.stack([hits[i][1] if i in hits else miss_last[row_of[i]]
                                   for i in range(n)])
        for r, slot in zip(reqs, slots):
            self._slot_custom[slot] = r.sampling is not None
        firsts = self._commit(last_logits, reqs, slots, plens)
        dt = time.time() - t0
        for req, slot, plen in zip(reqs, slots, plens):
            req.prefill_time = dt
            self.slot_req[slot] = req
            self.lengths[slot] = plen
            self._len_ub[slot] = plen
            self.active[slot] = True
        return firsts

    def _commit(self, last_logits: torch.Tensor, reqs: list, slots: list, plens: list):
        """Every per-slot write of an admission group and its first tokens,
        in one piece (JAX's `_admit_commit`), keyed by (group size padded to
        a power of two, custom sampling): the group's logits, sampling
        vectors, lengths and history rows (prompt tail, right-aligned) are
        staged into the key's buffers, padded rows repeating the last row
        with JAX's out-of-range slot index, which writes nothing (so do
        another rank's slots on a mesh). Every row is sampled, the padded
        ones too, so the generator draws alike on both routes. Returns the
        group's first tokens [n] on the device (the key's output buffer)."""
        n = len(reqs)
        npad = _pow2_at_least(n)
        hw = self.history.shape[1]
        eff = [r.sampling or self.sampling for r in reqs]
        custom = any(r.sampling is not None for r in reqs)
        # int64 columns: slot (local index; local_slots writes nothing), top_k,
        # length, then the history row
        ints = np.full((npad, 3 + hw), -2, np.int64)
        floats = np.zeros((npad, 3), np.float32)  # temperature, top_p, repetition penalty
        for i in range(npad):
            j = min(i, n - 1)
            s, r, pl = eff[j], reqs[j], plens[j]
            mine = i < n and self._mine(slots[i])
            ints[i, :3] = (slots[i] - self.slot0 if mine else self.local_slots, s.top_k, pl)
            tail = r.prompt_tokens[-min(pl, hw):]
            ints[i, 3 + hw - len(tail):] = tail
            floats[i] = (s.temperature, s.top_p, s.repetition_penalty)
        logits = self._buf("commit_logits", (npad, last_logits.shape[1]), last_logits.dtype)
        ints_t = self._buf("commit_ints", ints.shape, torch.int64)
        floats_t = self._buf("commit_floats", floats.shape, torch.float32)
        firsts = self._buf("commit_firsts", (npad,), torch.int32)
        logits[:n].copy_(last_logits)
        logits[n:].copy_(last_logits[-1:].expand(npad - n, -1))
        ints_t.copy_(torch.from_numpy(ints))
        floats_t.copy_(torch.from_numpy(floats))
        self._run(("commit", npad, custom),
                        functools.partial(self._commit_body, logits, ints_t, floats_t, firsts,
                                          custom))
        return firsts[:n]

    def _commit_body(self, logits, ints, floats, firsts, custom: bool) -> None:
        npad = logits.shape[0]
        slot = ints[:, 0]
        top_ks, plens = ints[:, 1].to(torch.int32), ints[:, 2].to(torch.int32)
        hist = ints[:, 3:].to(torch.int32)
        temps, top_ps, rep_pens = floats[:, 0], floats[:, 1], floats[:, 2]
        # a new slot's penalty window is empty
        fresh = torch.full((npad, self.prev_tokens.shape[1]), -1, dtype=torch.int32,
                           device=logits.device)
        if custom:
            sample = lambda: sample_tokens_batched(logits, temps, top_ks, top_ps, rep_pens, fresh,
                                                   generator=self.generator)
        else:
            sample = lambda: sample_tokens(logits, self.sampling, fresh, generator=self.generator)
        first = self._taken_once(sample, (npad,), over_tp=False)
        firsts.copy_(first)
        _set_rows(self._temps, slot, temps)
        _set_rows(self._top_ks, slot, top_ks)
        _set_rows(self._top_ps, slot, top_ps)
        _set_rows(self._rep_pens, slot, rep_pens)
        # the first token joins the window so decode's penalty sees it
        _set_rows(self.prev_tokens, slot, torch.cat([fresh[:, 1:], first[:, None]], dim=1))
        _set_rows(self.cur_tokens, slot, first)
        _set_rows(self._lengths_dev, slot, plens)
        _set_rows(self._active_dev, slot, torch.ones_like(first, dtype=torch.bool))
        # the speculative history: prompt tail ++ first token, right-aligned
        _set_rows(self.history, slot, torch.cat([hist[:, 1:], first[:, None]], dim=1))

    def _finish(self, slot: int, req: Request, reason: str) -> None:
        req.finished = True
        req.finish_reason = reason
        self.active[slot] = False
        self._active_dirty = True
        self.slot_req[slot] = None
        # back to the uniform-sampling path once no active slot is custom
        self._slot_custom[slot] = False
        if req.on_finish is not None:
            req.on_finish(req)

    def _emit(self, slot: int, token: int, cache_len: Optional[int] = None) -> None:
        """cache_len: cache rows used when THIS token was produced (the
        horizon loops pass it a token at a time, so that plain and
        speculative engines truncate alike near max_len)."""
        req = self.slot_req[slot]
        req.output_tokens.append(token)
        if req.stream:
            req.stream(token)
        stopped = (self.eos is not None and token == self.eos) or token in req.stop_token_ids
        if not stopped and req.stop_check is not None:
            if self._stop_at is not None:  # rank 0's verdict, on another rank of a mesh
                stopped = self._stop_at.get(slot) == len(req.output_tokens)
            else:
                stopped = bool(req.stop_check(req.output_tokens))
                if stopped and self.mesh is not None:
                    self._stops_fired[slot] = len(req.output_tokens)
        done = stopped or len(req.output_tokens) >= req.max_new_tokens
        if (self.lengths[slot] if cache_len is None else cache_len) + 1 >= self.max_len:
            done = True
        if done:
            self._finish(slot, req, "stop" if stopped else "length")

    def _cache_len(self) -> int:
        return self.cache.k.shape[3]

    def _ensure_cache(self, needed: int) -> None:
        """Grow the KV cache to the smallest bucket covering `needed`
        positions (never shrinks; nothing unless grow_cache)."""
        needed = min(needed, self.max_len)
        old = self._cache_len()
        if not self.grow_cache or needed <= old:
            return
        new_len = next((b for b in self.cache_buckets if b >= needed), self.max_len)
        self.cache = grow_kv_cache(self.cache, new_len)
        self.growths.append((old, new_len))
        if self._graphs is not None:
            self._graphs.drop(old)

    def _spec_active(self) -> tuple:
        """(spec, probe) for one round, decided once a round. Custom per-slot
        sampling and a non-unit engine repetition penalty take the plain
        step (the verify samples every position with the engine's params and
        the round-start penalty window); so does acceptance under
        spec_min_accept, with a one-round probe every spec_retry_every
        rounds."""
        if (not self.spec_decode or bool(self._slot_custom.any())
                or self.sampling.repetition_penalty != 1.0):
            return False, False
        if self._spec_ema is not None and self._spec_ema < self.spec_min_accept:
            self._spec_off_rounds += 1
            return self._spec_off_rounds % self.spec_retry_every == 0, True
        return True, False

    @staticmethod
    def _invert_geometric(e: float, k: int) -> float:
        """Solve E_k(p) = p (1 - p^k) / (1 - p) = e for the per-position
        acceptance probability p (monotonic in p; bisection)."""
        if e <= 0.0:
            return 0.0
        if e >= k - 1e-6:
            return 1.0
        lo, hi = 0.0, 1.0 - 1e-9
        for _ in range(40):
            mid = (lo + hi) / 2
            if mid * (1 - mid ** k) / (1 - mid) < e:
                lo = mid
            else:
                hi = mid
        return (lo + hi) / 2

    def _current_spec_k(self) -> int:
        """Adaptive draft length: invert the acceptance EMA (measured at the
        last dispatched k) through the geometric model, then take the ladder
        k maximizing expected tokens per verify cost (E_k(p) + 1) / (1 +
        SPEC_STEP_COST k), with 3% hysteresis."""
        if not self.spec_adaptive_k or self._spec_ema is None:
            return self._spec_k_cur
        p = self._invert_geometric(max(self._spec_ema - 1.0, 0.0), max(self._spec_k_last, 1))

        def value(k):
            e_k = k if p >= 1.0 else p * (1 - p ** k) / (1 - p)
            return (e_k + 1.0) / (1.0 + SPEC_STEP_COST * k)

        best = max(self.spec_k_ladder, key=value)
        if value(best) > value(self._spec_k_cur) * 1.03:
            self._spec_k_cur = best
        return self._spec_k_cur

    def _dispatch_decode(self, steps: int, spec: Optional[bool] = None,
                         spec_k: Optional[int] = None):
        """Dispatch one decode horizon and start its tokens' copy to the
        host; returns (fetch, speculative). Plain: tokens [steps, B];
        speculative: tokens [steps, B, k + 1] and counts [steps, B] (B: every
        slot, gathered over a mesh's dp). The cache grows first to cover
        every active slot's upper bound."""
        if self._spec_active()[0] if spec is None else spec:
            k = self._current_spec_k() if spec_k is None else spec_k
            self._spec_k_last = k
            if self.active.any():
                self._ensure_cache(int(self._len_ub[self.active].max()) + steps * (k + 1))
            toks, counts = self._spec_decode(steps, k)
            self._len_ub += steps * (k + 1) * self.active
            return _Fetch([self._all_slots(toks), self._all_slots(counts)]), True
        if self.active.any():
            self._ensure_cache(int(self._len_ub[self.active].max()) + steps)
        toks = self._decode(steps, custom=bool(self._slot_custom.any()))
        self._len_ub += steps * self.active
        return _Fetch([self._all_slots(toks)]), False

    def _end_full_slots(self, skip: set, done: list) -> None:
        """A slot without room for one more token ends ("length"); newly
        admitted slots are skipped (their first token is still pending)."""
        for i in range(self.max_slots):
            if self.active[i] and i not in skip and self.lengths[i] + 1 >= self.max_len:
                req = self.slot_req[i]
                self._finish(i, req, "length")
                done.append(req)

    def run(
        self,
        requests: Iterable[Request],
        *,
        feeder: Optional[Callable[[bool], list]] = None,
        stop: Optional[Callable[[], bool]] = None,
    ) -> list[Request]:
        """Continuous-batching loop until every request finishes: admit into
        free slots, dispatch a horizon for the active slots, read its tokens
        once, emit.

        `feeder(idle)` is polled at every admission round for requests that
        arrive during the run (the HTTP frontend); it returns at once when
        idle is False and may block briefly when idle is True. With a feeder
        the loop ends when no work remains and `stop()` is True. On a mesh
        every rank passes the same `requests`; `feeder` and `stop` are called
        on global rank 0 alone and what they return reaches every rank (the
        other ranks pass a feeder only to keep their loop polling)."""
        queue = list(requests)
        done: list[Request] = []
        pending = len(queue)
        while pending or feeder is not None:
            if feeder is not None:
                halt, new = self._poll(feeder, stop, pending,
                                       not self.active.any() and not queue)
                if halt:
                    break
                queue.extend(new)
                pending += len(new)
                if not queue and not self.active.any():
                    continue  # idle poll (the feeder blocks)
            admit_reqs, admit_slots = [], []
            while queue:
                slot = self._free_slot()
                if slot is None:
                    break
                admit_reqs.append(queue.pop(0))
                admit_slots.append(slot)
                self.active[slot] = True  # reserve while gathering
            firsts = None
            if admit_reqs:
                for s in admit_slots:
                    self.active[s] = False  # _admit_group re-activates
                firsts = _Fetch([self._admit_group(admit_reqs, admit_slots)])
            if not self.active.any():
                continue
            pending_first = set(admit_slots)
            before = len(done)
            self._end_full_slots(pending_first, done)
            pending -= len(done) - before
            if not self.active.any():
                continue
            # the horizon: bounded by the LARGEST remaining budget (overshoot
            # past a smaller one is dropped at emit) and the cache headroom;
            # powers of two
            max_rem = max(self.slot_req[i].max_new_tokens - len(self.slot_req[i].output_tokens)
                          - (1 if i in pending_first else 0)
                          for i in range(self.max_slots) if self.active[i])
            headroom = self.max_len - 1 - int(
                max(self.lengths[i] for i in range(self.max_slots) if self.active[i]))
            steps = self.horizon
            spec_now, spec_probe = self._spec_active()
            spec_k_now = self._current_spec_k() if spec_now else None
            # a verify writes k + 1 rows even at steps 1: without that
            # headroom its write would clamp over attended rows
            if spec_now and headroom < spec_k_now + 1:
                spec_now = False
            tpr = (spec_k_now + 1) if spec_now else 1
            # at high acceptance a budget completes in max_rem / rate rounds:
            # bound the horizon by that estimate (the last horizon's rate
            # bounds a cold EMA from below)
            budget_rounds = max_rem
            est = max(self._spec_ema or 0.0, self._spec_last_rate)
            if spec_now and est > 1.0:
                budget_rounds = int(-(-max_rem // est))
            while steps > 1 and (steps > max(budget_rounds, 1) or steps * tpr > headroom):
                steps //= 2
            if spec_now and spec_probe:
                steps = 1  # a cheap probe: one verify round
            dispatch_active = self.active.copy()
            if self._active_dirty:  # upload only when a slot changed
                self._active_dev.copy_(torch.from_numpy(
                    dispatch_active[self.slot0:self.slot0 + self.local_slots]))
                self._active_dirty = False
            t0 = time.time()
            fetch, spec = self._dispatch_decode(steps, spec=spec_now, spec_k=spec_k_now)
            firsts_np = firsts.wait()[0] if firsts is not None else None
            got = fetch.wait()
            toks_np, counts_np = (got[0], got[1]) if spec else (got[0], None)
            dt = time.time() - t0
            if counts_np is not None:
                cells = int((counts_np > 0).sum())
                self.spec_rounds += cells
                self.spec_tokens += int(counts_np.sum())
                if cells:
                    rate = float(counts_np.sum()) / cells
                    self._spec_ema = (rate if self._spec_ema is None
                                      else 0.7 * self._spec_ema + 0.3 * rate)
                    self._spec_last_rate = rate
            # a mesh's stop_check verdicts: taken on rank 0 as it emits, the
            # other ranks receive them before they emit
            stop_sync = self.mesh is not None and any(
                self.slot_req[i] is not None and self.slot_req[i].stop_check is not None
                for i in range(self.max_slots) if dispatch_active[i])
            if stop_sync and not self._lead():
                box = [None]
                dist.broadcast_object_list(box, src=0)
                self._stop_at = box[0]
            if admit_reqs:
                for t_val, slot in zip(firsts_np, admit_slots):
                    self._emit(slot, int(t_val))
                for req in admit_reqs:
                    if req.finished:
                        done.append(req)
                        pending -= 1
            for i in range(self.max_slots):
                if not dispatch_active[i]:
                    continue
                req = self.slot_req[i]
                if req is None or req.finished:
                    continue  # finished by its first token: the horizon is overshoot
                emitted = 0
                start_len = int(self.lengths[i])
                if counts_np is None:  # plain: one token a round
                    self.lengths[i] += steps
                    n_round = steps
                    for h in range(steps):
                        emitted += 1
                        self._emit(i, int(toks_np[h, i]), start_len + h + 1)
                        if req.finished:
                            break
                else:  # speculative: counts_np[h, i] tokens a round
                    self.lengths[i] += int(counts_np[:, i].sum())
                    n_round = max(int(counts_np[:, i].sum()), 1)
                    for h in range(steps):
                        for j in range(int(counts_np[h, i])):
                            emitted += 1
                            self._emit(i, int(toks_np[h, i, j]), start_len + emitted)
                            if req.finished:
                                break
                        if req.finished:
                            break
                req.decode_tokens += emitted
                req.decode_time += dt * emitted / n_round
                if req.finished:
                    done.append(req)
                    pending -= 1
            if stop_sync and self._lead():
                dist.broadcast_object_list([self._stops_fired], src=0)
            self._stops_fired, self._stop_at = {}, None
        return done

    def _poll(self, feeder, stop, pending: int, idle: bool) -> tuple:
        """(halt, new requests) of one admission round: `stop()` (once
        nothing is pending; True ends the loop) and `feeder(idle)`, taken on
        global rank 0 and, on a mesh, broadcast to every rank, which builds
        the requests from their data: the same requests in the same round,
        in the same order, on every rank."""
        halt, new = False, []
        if self._lead():
            halt = not pending and stop is not None and bool(stop())
            new = [] if halt else list(feeder(idle))
        if self.mesh is None:
            return halt, new
        box = [(halt, [_wire(r) for r in new])] if self._lead() else [None]
        dist.broadcast_object_list(box, src=0)
        if not self._lead():
            halt, new = box[0][0], [_unwire(w) for w in box[0][1]]
        return halt, new

    def warmup(self, prompt_len: int = 64, verbose=None) -> None:
        """Run the engine's shapes once before live traffic: every admission
        group size (powers of two, distinct prompts so the dedup keeps every
        row), the full and tail horizons, each k of the adaptive ladder and,
        with grow_cache, one trajectory through every cache bucket. On the
        card that builds the kernels' lazily made tables and plans, warms
        the allocator and, on the graph route, captures every kind of step
        (plain uniform and custom, each k's verify) at the last bucket, and
        the admission pieces of each group size at the prompt length's
        bucket: prefill, commit (uniform and custom) and, at the first and
        the last cache bucket, insert. EOS
        and the speculative fallback are suspended for the walk, and the
        counters are restored after it."""
        t0 = time.time()
        plen = min(prompt_len, self.max_len // 2)
        saved = (self.eos, self.spec_min_accept, self._spec_ema, self._spec_last_rate,
                 self._spec_off_rounds, self.spec_rounds, self.spec_tokens,
                 self._spec_k_cur, self._spec_k_last, self.prompt_cache_hits,
                 self.prompt_cache_prefix_hits, self.prompt_cache_misses)
        self.eos = None
        self.spec_min_accept = -1.0  # keep the verify path running
        try:
            def prompts(n):  # distinct a slot: the dedup keeps n prefill rows
                return [list(range(3 + j, 3 + j + plen)) for j in range(n)]

            sizes = []
            nbs = self.max_slots
            while nbs >= 1:
                sizes.append(nbs)
                nbs //= 2
            for nbs in sizes:
                self.generate(prompts(nbs), max_new_tokens=self.horizon + 1)
            self.generate(prompts(1), max_new_tokens=max(self.horizon - 1, 1))
            if self.spec_decode and self.spec_adaptive_k:
                for k in self.spec_k_ladder:
                    self._spec_k_cur = k
                    self.spec_adaptive_k = False
                    try:
                        self.generate(prompts(self.max_slots), max_new_tokens=self.horizon + 1)
                        self.generate(prompts(1), max_new_tokens=2)
                    finally:
                        self.spec_adaptive_k = True
            if self.grow_cache and self.max_len > self._cache_len():
                # one full-length trajectory grows through every bucket
                self.generate(prompts(1), max_new_tokens=self.max_len - plen - 2)
                for nbs in sizes:
                    self.generate(prompts(nbs), max_new_tokens=1)
            if self._graphs is not None:
                # growth dropped the smaller buckets' graphs (the cache never
                # shrinks): one step of each kind over the idle slots captures
                # it at the bucket traffic reads
                for custom in (False, True):
                    self._decode(1, custom)
                for k in self.spec_k_ladder if self.spec_decode else ():
                    self._spec_decode(1, k)
                # the commit of a group with per-request sampling, each size
                for nbs in sizes:
                    self.run([Request(prompt_tokens=p, max_new_tokens=1, sampling=self.sampling)
                              for p in prompts(nbs)])
        finally:
            (self.eos, self.spec_min_accept, self._spec_ema, self._spec_last_rate,
             self._spec_off_rounds, self.spec_rounds, self.spec_tokens,
             self._spec_k_cur, self._spec_k_last, self.prompt_cache_hits,
             self.prompt_cache_prefix_hits, self.prompt_cache_misses) = saved
        if verbose:
            verbose(f"engine warmup done in {time.time() - t0:.1f}s")

    def generate(self, prompts: list, max_new_tokens: int = 256) -> list:
        reqs = [Request(prompt_tokens=p, max_new_tokens=max_new_tokens) for p in prompts]
        order = {id(r): i for i, r in enumerate(reqs)}
        out = [None] * len(reqs)
        for r in self.run(reqs):
            out[order[id(r)]] = r.output_tokens
        return out
