"""Serving engine: batched prefill and slot-based continuous batching
(PyTorch port of the core of the JAX package's `serve/engine.py`).

  * prompts are padded to power-of-two length buckets and prefilled
    together with the cache-less forward, which returns each layer's KV;
  * that KV is transposed to the cache's head-major layout and written into
    the admitted slots; the first token is sampled from the prompt logits;
  * one decode step advances ALL slots a token, each at its own position,
    and a horizon of `decode_horizon` steps ends in one host sync;
  * requests finish on EOS, a stop id, their token budget or the cache
    length.

With BITDISTILLER_QMM_A8=1 the engine serves W{2,4}A8: its weights are
repacked once at construction and every packed matmul quantizes its
activations to int8. The KV cache is allocated once at `max_len`. Speculative decoding, the
prompt cache, cache growth, pipelined rounds and sharding are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models import llama
from ..models.config import ModelConfig
from ..models.llama import KVCache, quantize_kv
from ..ops.quant_matmul import maybe_repack_a8
from .sampling import SamplingParams, sample_tokens, sample_tokens_batched


@dataclasses.dataclass
class Request:
    prompt_tokens: list
    max_new_tokens: int = 256
    sampling: Optional[SamplingParams] = None  # per-request override
    stop_token_ids: tuple = ()  # stop ids beyond the engine's eos
    # filled by the engine:
    output_tokens: list = dataclasses.field(default_factory=list)
    finished: bool = False
    finish_reason: str = ""


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
        device="cuda",
    ):
        self.device = resolve_device(device)
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
        dev = self.device
        self.cache = KVCache.init(cfg, max_slots, max_len, cache_dtype, device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        # device-side slot state: advanced by decode without host syncs
        self.prev_tokens = torch.full((max_slots, rep_window), -1, dtype=torch.int32, device=dev)
        self.cur_tokens = torch.zeros(max_slots, dtype=torch.int32, device=dev)
        self._lengths_dev = torch.zeros(max_slots, dtype=torch.int32, device=dev)
        self._active_dev = torch.zeros(max_slots, dtype=torch.bool, device=dev)
        self._temps = torch.full((max_slots,), sampling.temperature, dtype=torch.float32, device=dev)
        self._top_ks = torch.full((max_slots,), sampling.top_k, dtype=torch.int32, device=dev)
        self._top_ps = torch.full((max_slots,), sampling.top_p, dtype=torch.float32, device=dev)
        self._rep_pens = torch.full((max_slots,), sampling.repetition_penalty,
                                    dtype=torch.float32, device=dev)
        # host-side slot state
        self.slot_req: list[Optional[Request]] = [None] * max_slots
        self.lengths = np.zeros(max_slots, np.int32)
        self.active = np.zeros(max_slots, bool)
        self._slot_custom = np.zeros(max_slots, bool)
        self._active_dirty = True
        self.decode_steps = 0  # decode forwards run (each advances every slot)
        self.prefills = 0  # batched prefill forwards run

    # -- device pieces ------------------------------------------------------

    @torch.inference_mode()
    def _prefill(self, tokens: torch.Tensor, last_idx: torch.Tensor):
        """[nb, S] prompts -> last-position logits [nb, V], KV [L, nb, S, H, D]."""
        self.prefills += 1
        logits, kv = llama.forward(self.params, self.cfg, tokens, return_kv=True)
        last = logits[torch.arange(tokens.shape[0], device=tokens.device), last_idx]
        return last, kv

    @torch.inference_mode()
    def _insert(self, kv: KVCache, slots: list, rows: list) -> None:
        """Write prefill rows [0, S) into the slots' cache planes, transposed
        to head-major [L, H, S, D]. Rows past a prompt's length hold padding
        and stay masked by the slot's position (t < cache_pos)."""
        nk = kv.k.permute(0, 1, 3, 2, 4)  # [L, nb, H, S, D]
        nv = kv.v.permute(0, 1, 3, 2, 4)
        s = nk.shape[3]
        ks = vs = None
        if self.cache.quantized:
            nk, ks = quantize_kv(nk)
            nv, vs = quantize_kv(nv)
        for slot, row in zip(slots, rows):
            self.cache.k[:, slot, :, :s] = nk[:, row].to(self.cache.k.dtype)
            self.cache.v[:, slot, :, :s] = nv[:, row].to(self.cache.v.dtype)
            if ks is not None:
                self.cache.k_scale[:, slot, :, :s] = ks[:, row]
                self.cache.v_scale[:, slot, :, :s] = vs[:, row]

    @torch.inference_mode()
    def _decode(self, steps: int, custom: bool) -> torch.Tensor:
        """`steps` decode steps for every slot; returns tokens [steps, B] on
        the device. Inactive slots decode masked junk into their own rows."""
        max_pos = self.max_len - 1
        self.decode_steps += steps
        tokens, pos = self.cur_tokens, self._lengths_dev.clone()
        out = []
        for _ in range(steps):
            logits, _ = llama.forward(
                self.params, self.cfg, tokens[:, None], cache=self.cache, cache_pos=pos,
            )
            if custom:
                nxt = sample_tokens_batched(
                    logits[:, 0], self._temps, self._top_ks, self._top_ps,
                    self._rep_pens, self.prev_tokens, generator=self.generator,
                )
            else:
                nxt = sample_tokens(logits[:, 0], self.sampling, self.prev_tokens,
                                    generator=self.generator)
            nxt = torch.where(self._active_dev, nxt, 0)
            self.prev_tokens = torch.cat([self.prev_tokens[:, 1:], nxt[:, None]], dim=1)
            pos = torch.clamp(pos + 1, max=max_pos)
            tokens = nxt
            out.append(nxt)
        self.cur_tokens = tokens
        self._lengths_dev = self._lengths_dev + steps * self._active_dev.to(torch.int32)
        return torch.stack(out)

    # -- host scheduling ----------------------------------------------------

    def _free_slot(self) -> Optional[int]:
        for i in range(self.max_slots):
            if not self.active[i]:
                return i
        return None

    @torch.inference_mode()
    def _admit_group(self, reqs: list, slots: list) -> torch.Tensor:
        """Prefill several requests in one batched call, insert each into its
        slot and sample its first token (on the device; returned unsynced)."""
        dev = self.device
        n = len(reqs)
        # truncate from the left so the cache never overflows
        plens = [min(len(r.prompt_tokens), self.max_len - 1) for r in reqs]
        bucket = next(b for b in self.buckets if b >= max(plens))
        nb = min(_pow2_at_least(n), self.max_slots)  # bounded set of batch shapes
        padded = np.zeros((nb, bucket), np.int64)
        last_idx = np.zeros(nb, np.int64)
        for row, (r, pl) in enumerate(zip(reqs, plens)):
            padded[row, :pl] = r.prompt_tokens[-pl:]
            last_idx[row] = pl - 1
        last, kv = self._prefill(torch.from_numpy(padded).to(dev), torch.from_numpy(last_idx).to(dev))
        self._insert(kv, slots, range(n))
        del kv

        slot_t = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        last_logits = last[:n]
        eff = [r.sampling or self.sampling for r in reqs]
        self.prev_tokens[slot_t] = -1
        self._temps[slot_t] = torch.as_tensor([s.temperature for s in eff], dtype=torch.float32, device=dev)
        self._top_ks[slot_t] = torch.as_tensor([s.top_k for s in eff], dtype=torch.int32, device=dev)
        self._top_ps[slot_t] = torch.as_tensor([s.top_p for s in eff], dtype=torch.float32, device=dev)
        self._rep_pens[slot_t] = torch.as_tensor(
            [s.repetition_penalty for s in eff], dtype=torch.float32, device=dev)
        for r, slot in zip(reqs, slots):
            self._slot_custom[slot] = r.sampling is not None
        if any(r.sampling is not None for r in reqs):
            firsts = sample_tokens_batched(
                last_logits, self._temps[slot_t], self._top_ks[slot_t], self._top_ps[slot_t],
                self._rep_pens[slot_t], self.prev_tokens[slot_t], generator=self.generator,
            )
        else:
            firsts = sample_tokens(last_logits, self.sampling, self.prev_tokens[slot_t],
                                   generator=self.generator)
        # the first token joins the window so decode's penalty sees it
        self.prev_tokens[slot_t, -1] = firsts
        self.cur_tokens[slot_t] = firsts
        self._lengths_dev[slot_t] = torch.as_tensor(plens, dtype=torch.int32, device=dev)
        self._active_dev[slot_t] = True
        for req, slot, plen in zip(reqs, slots, plens):
            self.slot_req[slot] = req
            self.lengths[slot] = plen
            self.active[slot] = True
        return firsts

    def _finish(self, slot: int, req: Request, reason: str) -> None:
        req.finished = True
        req.finish_reason = reason
        self.active[slot] = False
        self._active_dirty = True
        self.slot_req[slot] = None
        self._slot_custom[slot] = False

    def _emit(self, slot: int, token: int, cache_len: Optional[int] = None) -> None:
        """cache_len: cache rows used when THIS token was produced."""
        req = self.slot_req[slot]
        req.output_tokens.append(token)
        stopped = (self.eos is not None and token == self.eos) or token in req.stop_token_ids
        done = stopped or len(req.output_tokens) >= req.max_new_tokens
        if (self.lengths[slot] if cache_len is None else cache_len) + 1 >= self.max_len:
            done = True
        if done:
            self._finish(slot, req, "stop" if stopped else "length")

    def run(self, requests: Iterable[Request]) -> list[Request]:
        """Continuous-batching loop until every request finishes: admit into
        free slots, decode a horizon for all active slots, sync once, emit."""
        queue = list(requests)
        done: list[Request] = []
        while queue or self.active.any():
            admit_reqs, admit_slots = [], []
            while queue:
                slot = self._free_slot()
                if slot is None:
                    break
                admit_reqs.append(queue.pop(0))
                admit_slots.append(slot)
                self.active[slot] = True  # reserve while gathering
            firsts_dev = None
            if admit_reqs:
                for s in admit_slots:
                    self.active[s] = False
                firsts_dev = self._admit_group(admit_reqs, admit_slots)
            pending_first = set(admit_slots)
            # a slot without room for one more token ends (newly admitted
            # slots are skipped: their first token is still pending)
            for i in range(self.max_slots):
                if (self.active[i] and i not in pending_first
                        and self.lengths[i] + 1 >= self.max_len):
                    req = self.slot_req[i]
                    self._finish(i, req, "length")
                    done.append(req)
            if not self.active.any():
                continue
            # horizon: bounded by the LARGEST remaining budget (overshoot past
            # a smaller one is dropped at emit) and the cache headroom;
            # power-of-two only, as in the JAX engine
            rems = [
                self.slot_req[i].max_new_tokens - len(self.slot_req[i].output_tokens)
                - (1 if i in pending_first else 0)
                for i in range(self.max_slots) if self.active[i]
            ]
            headroom = self.max_len - 1 - int(
                max(self.lengths[i] for i in range(self.max_slots) if self.active[i])
            )
            steps = self.horizon
            while steps > 1 and (steps > max(max(rems), 1) or steps > headroom):
                steps //= 2
            dispatch_active = self.active.copy()
            if self._active_dirty:
                self._active_dev = torch.as_tensor(dispatch_active, device=self.device)
                self._active_dirty = False
            toks = self._decode(steps, custom=bool(self._slot_custom.any()))
            # THE host sync of this round: first tokens + horizon tokens
            if firsts_dev is not None:
                firsts_np = firsts_dev.cpu().numpy()
            toks_np = toks.cpu().numpy()
            if admit_reqs:
                for t_val, slot in zip(firsts_np, admit_slots):
                    self._emit(slot, int(t_val))
                done.extend(r for r in admit_reqs if r.finished)
            for i in range(self.max_slots):
                if not dispatch_active[i]:
                    continue
                req = self.slot_req[i]
                if req is None or req.finished:
                    continue  # finished by its first token: horizon is overshoot
                start_len = int(self.lengths[i])
                self.lengths[i] += steps
                for h in range(steps):
                    self._emit(i, int(toks_np[h, i]), start_len + h + 1)
                    if req.finished:
                        break
                if req.finished:
                    done.append(req)
        return done

    def generate(self, prompts: list, max_new_tokens: int = 256) -> list:
        reqs = [Request(prompt_tokens=p, max_new_tokens=max_new_tokens) for p in prompts]
        order = {id(r): i for i, r in enumerate(reqs)}
        out = [None] * len(reqs)
        for r in self.run(reqs):
            out[order[id(r)]] = r.output_tokens
        return out
