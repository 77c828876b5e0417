"""Continuous-batching serving engine over the paged KV cache (the
reference's models/continuous.py).

A fixed pool of B slots: requests are admitted into released slots while
their neighbours keep decoding, and pages return through the cache's free
stack. The design is the reference's:

  * one decode program for the whole static batch every harvest: empty
    and finished slots ride along masked (``active``), neither growing nor
    writing KV, their sampled tokens discarded. ``decode_steps=K`` runs K
    such steps in one program (the reference's K-step ``lax.scan``); a
    slot that hits EOS or its budget mid-program flips inactive there.
    On the card the K steps (the paged mega step, greedy sampling and the
    active / remaining / EOS masks) are captured once as a CUDA graph and
    every harvest is ONE ``graph.replay()``, after which the host reads
    the tokens once; on the CPU the same steps run eagerly;
  * admission is ``Qwen3.prefill_slot``: a one-row prefill whose page
    writes land only in the admitted slot, prompts padded to power-of-two
    buckets, long prompts in ``prefill_chunk`` chunks (one per step) that
    attend the slot's earlier pages; prefill chunks run eagerly;
  * release is ``PagedKVCache.release``; with ``prefix_cache`` the full
    pages of finished prompts are indexed by a hash chain and pinned, and
    a new request adopts the longest indexed prefix (LRU eviction under
    page pressure); admission reserves every live slot's worst-case
    growth, so two requests never share a page mid-decode.

Modes "xla" and "triton_dist_AR" (the model's backend for both the decode
step and the prefills); "triton_dist" batch-shards and raises, as in the
reference. ``mega`` ("auto": pallas_chain on the card, xla on the CPU)
runs the paged mega graph for Qwen3-family models in mode "xla"; every
other model and mode, and "off", call the model's ``inference``. No fallback: a tier that fails raises.

Tensor parallelism (``model.ctx.world`` n > 1, one engine per rank
process, every rank given the same submissions): every rank samples, then
takes rank 0's tokens (an NCCL broadcast captured in the graph; eager on
the CPU), and counts the steps on which its own sample differed
(``own_token_differs``), as the static Engine does.

An expert-parallel MoE model (``moe_parallel="ep"``) serves in mode "xla":
the paged mega graph's moe task (its pallas_chain tier dispatches each
rank's share of the rows to the experts' owners). The pairs its captured
steps drop for capacity are read with each harvest and warned about
(layers/ep_a2a_layer.py).

Waiting, each raising with its ROADMAP item: temperature / top-p sampling
with per-request threefry streams (A2); the request journal and
``recover`` (A7's rest, with A8's fault and observability hooks);
speculative decode (A12).
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import OrderedDict, deque

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels import launch_counts
from triton_dist_tpu_torch.kernels.allreduce import AllReduceMethod
from triton_dist_tpu_torch.layers.ep_a2a_layer import (
    pending_overflow, report_overflow,
)
from triton_dist_tpu_torch.models.engine import (
    cache_state, restore_cache_state,
)
from triton_dist_tpu_torch.models.utils import (
    logger, sample_token, sample_token_rows,
)

_I32 = torch.int32


@dataclasses.dataclass
class Request:
    """One generation request (id, prompt, budget, accumulated output)."""
    uid: int
    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    prefill_pos: int = 0    # tokens prefilled so far (chunked admission)
    adopted_pages: int = 0  # prefix-cache pages adopted at admission
    replaying: bool = False  # preempted: re-prefill committed, not prompt
    priority: bool = False   # head-of-queue admission class
    deadline: float | None = None  # time.monotonic() cutoff (timeout_s)
    timed_out: bool = False  # finished by deadline expiry (partial out)
    t_submit: float = 0.0    # time.monotonic() at submit
    t_first: float | None = None   # time.monotonic() at the first token

    @property
    def committed(self) -> list[int]:
        """Tokens that must be in the KV cache before this request can
        decode: the prompt plus, after a preemption, every emitted token
        but the pending one (the decode step writes that one itself)."""
        return self.prompt + self.out[:-1] if self.out else self.prompt

    @property
    def prefill_target(self) -> list[int]:
        """What _advance_prefill writes: the committed replay when
        resuming after preemption, otherwise the prompt."""
        return self.committed if self.replaying else self.prompt

    @property
    def prefilling(self) -> bool:
        target_len = len(self.prompt)
        if self.replaying and self.out:
            target_len += len(self.out) - 1
        return self.prefill_pos < target_len


def _bucket(n: int) -> int:
    """Smallest power of two >= n (bounds the prefill shapes)."""
    b = 1
    while b < n:
        b *= 2
    return b


class ContinuousEngine:
    """Slot-scheduled serving loop.

        eng = ContinuousEngine(model, params, max_batch=4)
        eng.submit([1, 2, 3], max_new_tokens=16)
        eng.submit([4, 5], max_new_tokens=8, eos_id=7)
        finished = eng.run()          # drain everything
        # or: eng.step() repeatedly, harvesting finished requests
    """

    def __init__(self, model, params: dict, max_batch: int,
                 temperature: float = 0.0, page_size: int = 128,
                 num_pages: int | None = None,
                 kv_resident: str | None = None,
                 kv_hbm_budget: int | None = None,
                 prefill_chunk: int | None = None,
                 prefix_cache: bool = False,
                 mode: str = "xla", decode_steps: int = 1,
                 mega: str = "auto", spec: str = "off",
                 verbose: bool = False):
        if mode not in ("xla", "triton_dist_AR"):
            raise ValueError(
                f"ContinuousEngine mode must be 'xla' or 'triton_dist_AR' "
                f"(got {mode!r}); 'triton_dist' batch-shards and cannot "
                "serve per-slot admissions")
        if temperature != 0.0:
            raise NotImplementedError(
                "ContinuousEngine sampling (per-request threefry streams, "
                "temperature > 0) waits for ROADMAP A2; use "
                "temperature=0.0")
        if spec != "off":
            raise NotImplementedError(
                "speculative decode waits for ROADMAP A12")
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got {decode_steps}")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, "
                             f"got {prefill_chunk}")
        if params["embed"].device != model.device:
            raise ValueError(f"params on {params['embed'].device}, model on "
                             f"{model.device}")
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.mode = mode
        self.decode_steps = decode_steps
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = prefix_cache
        self._prefix_index: OrderedDict[str, int] = OrderedDict()
        self.verbose = verbose
        self.cache = model.create_paged_kv_cache(
            max_batch, page_size=page_size, num_pages=num_pages,
            kv_resident=kv_resident, kv_hbm_budget=kv_hbm_budget)
        self.slots: list[Request | None] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self.finished: list[Request] = []
        self._next_uid = 0
        # host mirror of each slot's pending token (sampled last step)
        self._pending = [0] * max_batch
        self.mega = mega
        self._mega = None
        if mega != "off":
            from triton_dist_tpu_torch.mega.runtime import MegaDecodeRuntime
            self._mega = MegaDecodeRuntime(model, mode=mode, method=mega)
        world = model.ctx.world
        self._mesh = model.ctx.mesh if world > 1 else None
        # a row-split all-reduce (TWO_SHOT, RHD, the int8 ring QINT8)
        # hands each rank rows/n rows: prefill chunks are padded to a
        # multiple of the world (the pad rows are masked), and the decode
        # batch must be one
        self._rows_multiple = 1
        if (mode == "triton_dist_AR" and world > 1
                and model.ctx.gemm_ar_method is None
                and model.ctx.ar_method in (AllReduceMethod.TWO_SHOT,
                                            AllReduceMethod.RHD,
                                            AllReduceMethod.QINT8)):
            self._rows_multiple = world
            if max_batch % world:
                raise ValueError(
                    f"ar_method {model.ctx.ar_method.name} at world {world} "
                    f"needs max_batch divisible by the world; got "
                    f"{max_batch}")
        dev = model.device
        k = decode_steps
        # the decode program's static buffers: inputs (pending tokens,
        # active, remaining budget, EOS id; one H2D copy per harvest) and
        # outputs (K steps of tokens and emit masks); the captured graph
        # reads and writes them by address
        self._in = torch.zeros((4, max_batch), dtype=_I32, device=dev)
        self._toks = torch.zeros((k, max_batch), dtype=_I32, device=dev)
        self._emit = torch.zeros((k, max_batch), dtype=torch.bool,
                                 device=dev)
        self._differs = torch.zeros((), dtype=torch.int64, device=dev)
        self._prefill_differs = 0
        self._graph = None
        self.graph_launches: dict[str, int] = {}
        self.graph_replays = 0
        self._stats = {
            "submitted": 0, "finished": 0, "cancelled": 0,
            "preemptions": 0, "tokens_out": 0, "decode_batches": 0,
            "decode_slot_steps": 0, "prefill_chunks": 0,
            "admission_deferrals": 0, "evicted_pages": 0, "timed_out": 0,
            "prefix_pages_adopted": 0,
        }

    # -- public API --------------------------------------------------------

    def validate(self, prompt: list[int], max_new_tokens: int) -> None:
        """Raise ValueError if this request could never be served (the
        checks submit() applies)."""
        if not prompt:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        total = len(prompt) + max_new_tokens
        if total > self.model.max_length:
            raise ValueError(f"prompt+budget {total} exceeds max_length "
                             f"{self.model.max_length}")
        if self._pages_for(total) > self.cache.num_pages:
            raise ValueError(
                f"request needs {self._pages_for(total)} pages but the pool "
                f"holds {self.cache.num_pages}; enlarge num_pages")

    def submit(self, prompt: list[int], max_new_tokens: int,
               eos_id: int | None = None, priority: bool = False,
               timeout_s: float | None = None) -> int:
        """Queue a request; returns its uid. priority=True queues it ahead
        of every non-priority request (FIFO among priority ones); pair
        with preempt() to hand it a slot now. timeout_s: a deadline from
        now; an expired request finishes with what it emitted, flagged
        .timed_out."""
        self.validate(prompt, max_new_tokens)
        req = Request(self._next_uid, list(prompt), max_new_tokens, eos_id)
        req.t_submit = time.monotonic()
        if timeout_s is not None:
            req.deadline = req.t_submit + timeout_s
        self._next_uid += 1
        req.priority = priority
        if priority:
            self._insert_after_priority_prefix(req)
        else:
            self.queue.append(req)
        self._stats["submitted"] += 1
        return req.uid

    def _insert_after_priority_prefix(self, req: Request) -> None:
        """Behind the waiting priority requests (always a queue prefix),
        ahead of every non-priority entry."""
        idx = len(self.queue)
        for i, r in enumerate(self.queue):
            if not r.priority:
                idx = i
                break
        self.queue.insert(idx, req)

    @property
    def own_token_differs(self) -> int:
        """At world n: the sampled steps (prefill tokens, decode steps) on
        which this rank's own greedy token differed from rank 0's on some
        live row (every rank serves rank 0's tokens). Reads the device."""
        return self._prefill_differs + int(self._differs)

    def stats(self) -> dict:
        """Serving counters and live gauges; host state only."""
        return {
            **self._stats,
            "queue_depth": len(self.queue),
            "slots_busy": sum(r is not None for r in self.slots),
            "slots_total": self.max_batch,
            "prefix_index_entries": len(self._prefix_index),
            "decode_steps": self.decode_steps,
            "mode": self.mode,
            "kv_resident": self.cache.resident_codec or "off",
            "kv_hbm_bytes_per_token": self.cache.hbm_bytes_per_token(),
            "mega": ("off" if self._mega is None
                     else self._mega.method.value),
            "mega_launches": (0 if self._mega is None
                              else self._mega.launches),
            "graph_replays": self.graph_replays,
        }

    def _pages_for(self, tokens: int) -> int:
        return -(-tokens // self.cache.page_size)

    def step(self) -> list[Request]:
        """Admit what fits, advance one prefill chunk per prefilling slot,
        decode one harvest for every decodable slot; returns every request
        that finished in this step (those whose prefill token already hit
        EOS or a 1-token budget, and those whose deadline expired,
        included)."""
        done = self._expire_deadlines()
        done += self._admit()
        for slot, req in enumerate(self.slots):
            if req is not None and req.prefilling:
                if self._advance_prefill(slot, req):
                    done.append(req)
        if any(r is not None and not r.prefilling for r in self.slots):
            done += self._decode_once()
        return done

    def run(self, recover: bool = False) -> list[Request]:
        """Drain queue and slots; returns every finished request in uid
        order. recover=True (crash recovery from the request journal)
        waits for ROADMAP A7's rest and A8."""
        if recover:
            self.recover()
        while self.queue or any(r is not None for r in self.slots):
            self.step()
        return sorted(self.finished, key=lambda r: r.uid)

    def recover(self) -> list[int]:
        raise NotImplementedError(
            "the request journal and recover() wait for ROADMAP A7's rest "
            "and A8 (the fault and observability hooks)")

    def _expire_deadlines(self) -> list[Request]:
        """Finish every queued or running request whose deadline passed,
        flagged .timed_out, its slot and pages freed."""
        now = time.monotonic()
        expired = [r.uid for r in list(self.queue)
                   if r.deadline is not None and now >= r.deadline]
        expired += [r.uid for r in self.slots
                    if r is not None and r.deadline is not None
                    and now >= r.deadline]
        out: list[Request] = []
        for uid in expired:
            req = self._cancel_impl(uid, count=False)
            if req is None:
                continue
            req.timed_out = True
            self._stats["timed_out"] += 1
            self.finished.append(req)
            out.append(req)
        return out

    def cancel(self, uid: int) -> Request | None:
        """Abort a request: a queued one leaves the queue, a running one
        releases its slot and pages. It is not appended to .finished.
        Returns the request, or None if the uid is unknown or done."""
        return self._cancel_impl(uid, count=True)

    def _cancel_impl(self, uid: int, count: bool = True) -> Request | None:
        for i, req in enumerate(self.queue):
            if req.uid == uid:
                del self.queue[i]
                req.done = True
                if count:
                    self._stats["cancelled"] += 1
                return req
        for slot, req in enumerate(self.slots):
            if req is not None and req.uid == uid:
                req.done = True
                self.slots[slot] = None
                self.cache.release(slot)
                if count:
                    self._stats["cancelled"] += 1
                if self.verbose:
                    logger.log(f"cancel uid={uid} (slot {slot} released)")
                return req
        return None

    def preempt(self, uid: int) -> Request | None:
        """Send a running request back to the head of the normal class of
        the queue (behind waiting priority requests): its slot and pages
        free now; re-admitted, it replays its committed tokens and goes on
        decoding exactly. Returns it, or None if it holds no slot."""
        for slot, req in enumerate(self.slots):
            if req is not None and req.uid == uid:
                if self.prefix_cache:
                    # pin the written full pages under their content keys:
                    # the replay adopts them back
                    written = (req.prefill_pos if req.prefilling
                               else len(req.committed))
                    self._index_tokens(slot, req.committed[:written])
                self.slots[slot] = None
                self.cache.release(slot)
                req.prefill_pos = 0
                req.adopted_pages = 0
                req.replaying = True
                self._insert_after_priority_prefix(req)
                self._stats["preemptions"] += 1
                if self.verbose:
                    logger.log(f"preempt uid={uid} (slot {slot} released)")
                return req
        return None

    def ensure_priority_progress(self) -> int | None:
        """If a priority request waits at the queue head while the slots
        (or the pages) are held by non-priority work, preempt the victim
        with the most remaining budget. Returns its uid or None."""
        if not self.queue or not self.queue[0].priority:
            return None
        if any(r is None for r in self.slots):
            # a slot is free, but the arrival may be blocked on pages
            worst, adopt_ids = self._admission_demand(self.queue[0])
            free = self.cache.num_pages - int(self.cache.next_free)
            avail = free - self._reserved_pages()
            evictable = 0
            if worst > avail and self._prefix_index:
                adoptable = set(adopt_ids)
                refs = self.cache.ref_count.cpu()
                evictable = sum(1 for pid in self._prefix_index.values()
                                if int(refs[pid]) == 1
                                and pid not in adoptable)
            if worst <= avail + evictable:
                return None
        candidates = [(r.max_new_tokens - len(r.out), r.uid)
                      for r in self.slots
                      if r is not None and not r.priority]
        if not candidates:
            return None
        _, uid = max(candidates)
        self.preempt(uid)
        return uid

    # -- admission ---------------------------------------------------------

    def _admission_demand(self, req: Request) -> tuple[int, list[int]]:
        """Worst-case pages ``req`` still needs to admit after adopting
        its cached prefix; the lookup LRU-touches the adoptable entries.
        Returns (worst_pages, adopt_ids)."""
        target = req.prefill_target
        adopt_ids = self._lookup_prefix(target)
        ps = self.cache.page_size
        remaining_new = req.max_new_tokens - len(req.out)
        worst = self._pages_for(
            max(len(target) - len(adopt_ids) * ps, 0) + remaining_new)
        return worst, adopt_ids

    def _reserved_pages(self) -> int:
        """Worst-case pages the live slots may still allocate (their
        admitted budgets minus what they already drew)."""
        ps = self.cache.page_size
        total = 0
        for req in self.slots:
            if req is None or req.done:
                continue
            own_final = (len(req.prompt) - req.adopted_pages * ps
                         + req.max_new_tokens)
            worst = self._pages_for(own_final)
            if req.prefilling:
                cached = req.prefill_pos
            else:
                cached = len(req.prompt) + max(len(req.out) - 1, 0)
            drawn = self._pages_for(max(cached - req.adopted_pages * ps, 0))
            total += max(worst - drawn, 0)
        return total

    def _evict_for(self, worst: int, avail: int,
                   adoptable: set[int]) -> int:
        """Unpin LRU prefix entries (skipping ``adoptable``) until
        ``worst <= avail`` or the index runs dry; returns the new avail."""
        while worst > avail and self._prefix_index:
            need = worst - avail
            batch: list[int] = []
            for key in list(self._prefix_index):
                if len(batch) >= need:
                    break
                pid = self._prefix_index[key]
                if pid in adoptable:
                    continue
                del self._prefix_index[key]
                batch.append(pid)
            if not batch:
                break
            self.cache.unpin_pages(self._pad(batch, self.cache.num_pages),
                                   len(batch))
            self._stats["evicted_pages"] += len(batch)
            free = self.cache.num_pages - int(self.cache.next_free)
            avail = free - self._reserved_pages()
        return avail

    def _admit(self) -> list[Request]:
        done_at_admit: list[Request] = []
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue[0]
            worst, adopt_ids = self._admission_demand(req)
            adoptable = set(adopt_ids)
            free = self.cache.num_pages - int(self.cache.next_free)
            avail = free - self._reserved_pages()
            if worst > avail:
                avail = self._evict_for(worst, avail, adoptable)
            if worst > avail:
                if not any(r is not None for r in self.slots):
                    raise RuntimeError(
                        f"request uid={req.uid} needs {worst} pages but "
                        f"only {avail} are available with no request left "
                        "to finish; the pool is fragmented past progress "
                        "— enlarge num_pages")
                self._stats["admission_deferrals"] += 1
                break
            self.queue.popleft()
            self.slots[slot] = req
            req.prefill_pos = 0
            self._adopt_cached_prefix(slot, req, adopt_ids)
            if self._advance_prefill(slot, req):
                done_at_admit.append(req)
            if self.verbose:
                logger.log(f"admit uid={req.uid} -> slot {slot} "
                           f"(prompt {len(req.prompt)})")
        return done_at_admit

    # -- prefix cache ------------------------------------------------------

    @staticmethod
    def _chain_key(prev: str, chunk: list[int]) -> str:
        """Rolling per-page key covering the whole prefix (a sha256
        chain)."""
        h = hashlib.sha256(prev.encode())
        h.update(b",".join(str(t).encode() for t in chunk))
        return h.hexdigest()

    def _lookup_prefix(self, prompt: list[int]) -> list[int]:
        """Page ids of the longest indexed prefix (full pages only, at
        least one token left to prefill); LRU-touches every hit."""
        if not self.prefix_cache:
            return []
        ps = self.cache.page_size
        ids: list[int] = []
        key = ""
        for j in range((len(prompt) - 1) // ps):
            key = self._chain_key(key, prompt[j * ps:(j + 1) * ps])
            pid = self._prefix_index.get(key)
            if pid is None:
                break
            self._prefix_index.move_to_end(key)
            ids.append(pid)
        return ids

    def _adopt_cached_prefix(self, slot: int, req: Request,
                             ids: list[int]) -> None:
        if not ids:
            return
        np_ = self.cache.block_table.shape[1]
        self.cache.adopt_prefix(slot, self._pad(ids, np_), len(ids))
        req.prefill_pos = len(ids) * self.cache.page_size
        req.adopted_pages = len(ids)
        self._stats["prefix_pages_adopted"] += len(ids)
        if self.verbose:
            logger.log(f"uid={req.uid}: adopted {len(ids)} cached prefix "
                       f"page(s) ({req.prefill_pos} tokens skipped)")

    def _index_tokens(self, slot: int, tokens: list[int]) -> None:
        """Pin and index the slot's full pages covering ``tokens`` under
        the chain keys of that content."""
        if not self.prefix_cache:
            return
        ps = self.cache.page_size
        full = len(tokens) // ps
        if full == 0:
            return
        row = self.cache.block_table[slot].tolist()
        new_ids: list[int] = []
        key = ""
        for j in range(full):
            key = self._chain_key(key, tokens[j * ps:(j + 1) * ps])
            if key in self._prefix_index:
                self._prefix_index.move_to_end(key)
            else:
                self._prefix_index[key] = row[j]
                new_ids.append(row[j])
        if new_ids:
            np_ = self.cache.block_table.shape[1]
            self.cache.pin_pages(self._pad(new_ids, np_), len(new_ids))

    def _pad(self, ids: list[int], width: int) -> torch.Tensor:
        """A fixed-width id vector on the device (the first len(ids)
        valid)."""
        return torch.tensor(ids + [0] * (width - len(ids)), dtype=_I32,
                            device=self.model.device)

    # -- prefill -----------------------------------------------------------

    def _advance_prefill(self, slot: int, req: Request) -> bool:
        """Run ONE prefill chunk of the request's committed tokens; on the
        final chunk of a fresh request sample and record its first token
        (a resuming request's pending token is out[-1]). Returns True if
        the request finished right there."""
        target = req.prefill_target
        resuming = req.replaying and bool(req.out)
        cap = self.prefill_chunk or self.model.max_length
        chunk = target[req.prefill_pos:req.prefill_pos + cap]
        final = req.prefill_pos + len(chunk) >= len(target)
        tok = self._prefill_chunk_call(slot, chunk,
                                       continuation=req.prefill_pos > 0,
                                       final=final and not resuming)
        self._stats["prefill_chunks"] += 1
        req.prefill_pos += len(chunk)
        if not final:
            return False
        req.replaying = False
        self._index_tokens(slot, req.prompt)
        if resuming:
            self._pending[slot] = req.out[-1]
            return False
        self._pending[slot] = tok
        return self._record_token(slot, req, tok)

    def _prefill_chunk_call(self, slot: int, chunk: list[int],
                            continuation: bool, final: bool) -> int:
        """One bucket-padded prefill chunk through prefill_slot, eager (the
        bucket rounded up to the rows a row-split all-reduce needs); on
        the final chunk the greedy first token (rank 0's at world
        n)."""
        t = len(chunk)
        m = self._rows_multiple
        bt = -(-min(_bucket(t), self.model.max_length) // m) * m
        ids = torch.tensor([chunk + [0] * (bt - t)], dtype=torch.long,
                           device=self.model.device)
        logits, self.cache = self.model.prefill_slot(
            self.params, self.cache, slot, ids, valid_len=t, mode=self.mode,
            continuation=continuation, emit_logits=final)
        if not final:
            return 0
        own = sample_token(logits)
        got = self._rank0(own)
        if self._mesh is not None:
            self._prefill_differs += int((got != own).any())
        return int(got[0])

    def _rank0(self, tok: torch.Tensor) -> torch.Tensor:
        """Rank 0's tokens on every rank (a broadcast at world n)."""
        if self._mesh is None:
            return tok
        got = tok.clone()
        dist.broadcast(got, src=dist.get_global_rank(self._mesh.group, 0),
                       group=self._mesh.group)
        return got

    # -- decode ------------------------------------------------------------

    def _decode_program(self) -> None:
        """K masked decode steps over the static buffers: each step the
        paged decode (the mega graph or ``inference``), greedy sampling,
        rank 0's tokens, then the reference's masks: inactive rows keep
        their token, active rows spend budget, and a row whose token is
        its EOS or whose budget runs out turns inactive for the rest."""
        if self._mega is not None:
            infer = self._mega.step_fn(self._mega.method.value)
        else:
            def infer(params, cache, ids, act):
                return self.model.inference(params, cache, ids,
                                            mode=self.mode, active=act)
        tokens, active = self._in[0], self._in[1] != 0
        remaining, eos = self._in[2], self._in[3]
        for i in range(self.decode_steps):
            logits, _ = infer(self.params, self.cache, tokens[:, None],
                              active)
            own = sample_token_rows(logits)
            nxt = self._rank0(own)
            if self._mesh is not None:
                self._differs += ((nxt != own) & active).any()
            nxt = torch.where(active, nxt, tokens)
            rem = remaining - active.to(_I32)
            done = active & ((nxt == eos) | (rem <= 0))
            self._toks[i].copy_(nxt)
            self._emit[i].copy_(active)
            tokens, active, remaining = nxt, active & ~done, rem

    def _capture(self) -> None:
        """Capture the decode program as a CUDA graph on a side stream:
        one warm-up there first with every row inactive (it builds and
        loads every kernel and makes every symmetric buffer and the
        stream's kernel workspaces, none of which may happen under
        capture), the cache's allocator state put back after it."""
        dev = self.model.device
        self._in.zero_()
        self._in[3].fill_(-1)
        saved = cache_state(self.cache)
        differs = self._differs.clone()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._decode_program()
        torch.cuda.current_stream(dev).wait_stream(side)
        restore_cache_state(self.cache, saved)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph, stream=side):
            self._decode_program()
        after = launch_counts()
        self._differs.copy_(differs)
        self.graph_launches = {k: after[k] - before[k] for k in after}
        self._graph = graph

    def _decode_once(self) -> list[Request]:
        live = [r is not None and not r.done and not r.prefilling
                for r in self.slots]
        remaining = [0 if (r is None or r.prefilling or r.done)
                     else r.max_new_tokens - len(r.out) for r in self.slots]
        # -1 never matches a token id: "no EOS" slots decode to budget
        eos = [-1 if (r is None or r.eos_id is None) else r.eos_id
               for r in self.slots]
        if self.model.device.type == "cuda" and self._graph is None:
            self._capture()
        self._in.copy_(torch.tensor([self._pending, live, remaining, eos],
                                    dtype=_I32))
        if self._graph is not None:
            launch = self._graph.replay
            self.graph_replays += 1
        else:
            launch = self._decode_program
        if self._mega is not None:
            self._mega.dispatch(launch)
        else:
            launch()
        return self._harvest()

    def _harvest(self) -> list[Request]:
        """Commit one program's (K, B) tokens and emit masks to the host
        requests: ONE device read per harvest."""
        k, b = self._toks.shape
        # an expert-parallel model's dropped-pair counter rides along
        ep = pending_overflow(self.model.device)
        host = torch.cat([self._toks.reshape(-1),
                          self._emit.reshape(-1).to(_I32),
                          self.cache.overflow.reshape(1).to(_I32),
                          *(() if ep is None else (ep.to(_I32),))]).tolist()
        if ep is not None:
            report_overflow(self.model.device, host.pop())
        toks, emit, overflow = host[:k * b], host[k * b:2 * k * b], host[-1]
        self._stats["decode_batches"] += 1
        newly_done = []
        for slot, req in enumerate(self.slots):
            if req is None or req.prefilling:
                continue
            slot_toks = [toks[i * b + slot] for i in range(k)
                         if emit[i * b + slot]]
            if not slot_toks:
                continue
            self._stats["decode_slot_steps"] += len(slot_toks)
            for tok in slot_toks:
                self._pending[slot] = tok
                if self._record_token(slot, req, tok):
                    newly_done.append(req)
                    break
        if overflow:
            # the admission reservation makes this unreachable; if it
            # fires, KV was cross-written and every live result is suspect
            raise RuntimeError(
                f"KV page pool overflowed by {overflow} page(s) — "
                "admission reservation failed to cover live growth")
        return newly_done

    def _record_token(self, slot: int, req: Request, tok: int) -> bool:
        """Append, check termination, release the slot when done."""
        req.out.append(tok)
        self._stats["tokens_out"] += 1
        if req.t_first is None:
            req.t_first = time.monotonic()
        hit_eos = req.eos_id is not None and tok == req.eos_id
        if hit_eos or len(req.out) >= req.max_new_tokens:
            req.done = True
            self._stats["finished"] += 1
            self.finished.append(req)
            self.slots[slot] = None
            self.cache.release(slot)
            if self.verbose:
                logger.log(f"finish uid={req.uid} ({len(req.out)} tokens)")
            return True
        return False
