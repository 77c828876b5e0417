"""Inference Engine (the reference's models/engine.py).

``serve`` prefills the prompt layer by layer (flash prefill, B1) and then
runs gen_len - 1 decode steps. On the default dense cache
(``cache_mode="dense"``) each decode step is the mega task graph
(mega/runtime.py; ``mega="auto"`` picks the pallas_chain tier on the card:
B1 at T = 1, B3 and B4) or, with ``mega="off"``, ``Qwen3.inference``. On
the card that step is warmed up once on a side stream, captured once as a
CUDA graph over static token and cache buffers, and every step is then one
``graph.replay()``: the reference's "jit IS the graph capture". Sampling
stays outside the graph. On the CPU the step runs eagerly.

With ``backend="triton_dist"`` the decode step is
``model.inference(mode="triton_dist")`` (B12 projections; for Qwen3MoE the
B14/B15 expert GEMMs), captured and replayed the same way; the mega graph
serves the "xla" backend only, as in the reference. Prefill always runs in
mode "xla", as in the reference.

On the paged cache (``cache_mode="paged"``) the decode step is
``Qwen3.inference`` over the pages (paged flash decode, B2), captured and
replayed the same way; as in the reference, ``mega`` is ignored there.
Speculative decode waits for ROADMAP A12.

With ``backend="triton_dist_AR"`` the decode step is
``model.inference(mode="triton_dist_AR")`` (the sums after the o and down
projections through ``ctx.ar_method``: B5 for ONE_SHOT, B6 for RHD, B28
for QINT8_OS, B27 at every hop of the QINT8 ring; or the fused B4 with
``ctx.gemm_ar_method``), captured the same way. B28 and the ring give
every rank the same bytes, so the broadcast of rank 0's tokens below
changes nothing there.

Tensor parallelism (``model.ctx.world`` n > 1, one Engine per rank
process): every rank is given the whole batch and returns the whole
batch's tokens. Prefill runs in "xla" on the whole batch. With
``backend="triton_dist"`` each rank decodes its B/n rows (B10 for the QKV
and gate/up projections, B13a for o and down, with ``ag_method`` /
``rs_method`` PALLAS; B11 and B13b, the bidirectional rings, with
PALLAS_BIDIR at n >= 3; for Qwen3MoE B14 and B15 across ranks for the
experts, or, expert-parallel (``moe_parallel="ep"``), the dispatch and
combine over ``ctx.ep_a2a_method``: B17, B18 under TD_QUANT=always, or
B16 + B17) in the captured step, samples them, and the ranks all-gather
the sampled tokens outside the graph. The replicated backends
("xla": the mega step at its defaults, B4 across ranks on the card; and
"triton_dist_AR") decode the whole batch on every rank; B5 leaves the
ranks' sums different in the last bit, so every rank takes rank 0's
sampled tokens (one broadcast outside the graph per token) and records
whether its own differed (``own_token_differs``). On the paged cache
every rank holds its hkv/n heads of the pool and the same block table.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.kernels import launch_counts
from triton_dist_tpu_torch.layers.common import check_mode
from triton_dist_tpu_torch.layers.ep_a2a_layer import check_overflow
from triton_dist_tpu_torch.models.kv_cache import KVCache, PagedKVCache
from triton_dist_tpu_torch.models.utils import logger, sample_token

MEGA_MODES = ("auto", "xla", "pallas_chain", "off")


class Engine:

    def __init__(self, model, params: dict, temperature: float = 0.0,
                 top_p: float = 1.0, backend: str = "xla",
                 cache_mode: str = "dense", page_size: int = 128,
                 num_pages: int | None = None,
                 kv_resident: str | None = None, mega: str = "auto",
                 spec: str = "off", verbose: bool = False):
        if cache_mode not in ("dense", "paged"):
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if mega not in MEGA_MODES:
            raise ValueError(f"mega={mega!r} not in {MEGA_MODES}")
        if spec != "off":
            raise NotImplementedError(
                "speculative decode waits for ROADMAP A12")
        check_mode(backend)
        world = model.ctx.world
        if params["embed"].device != model.device:
            raise ValueError(f"params on {params['embed'].device}, model on "
                             f"{model.device}")
        self.model = model
        self.params = params
        self.temperature = temperature
        self.top_p = top_p
        self.backend = backend
        self.cache_mode = cache_mode
        self.page_size = page_size
        self.num_pages = num_pages
        self.kv_resident = kv_resident
        self.mega = mega
        self.verbose = verbose
        self.kv_cache = None
        self.logger = logger
        self.last_prefill_s = 0.0         # timings of the last serve
        self.last_decode_s = 0.0
        self.last_decode_steps = 0
        # the dense decode step on the mega task graph, where it applies
        # (the Qwen3 family, dense cache, xla backend), as in the reference
        self._mega_rt = None
        if mega != "off" and cache_mode == "dense" and backend == "xla":
            from triton_dist_tpu_torch.mega.runtime import MegaDecodeRuntime
            rt = MegaDecodeRuntime(model, mode=backend, method=mega)
            self._mega_rt = rt if rt.kind == "qwen3" else None
        # the captured decode step (CUDA only) and its accounting: kernel
        # launches recorded per captured step, replays in the last serve
        self._graph = None
        self._tok_buf = None
        self._logits_buf = None
        self.graph_launches: dict[str, int] = {}
        self.graph_replays = 0
        # triton_dist at world n: this rank decodes its rows of the batch;
        # the replicated backends take rank 0's tokens
        self._sharded = world > 1 and backend == "triton_dist"
        self._replicated = world > 1 and not self._sharded
        self._differs: list[torch.Tensor] = []

    @property
    def own_token_differs(self) -> torch.Tensor | None:
        """(tokens,) bool of the last serve in a replicated backend at
        world n: whether this rank's own sampled token differed from rank
        0's, for the prefill token and each decode step (None elsewhere).
        Reads the device."""
        if not self._differs:
            return None
        return torch.stack(self._differs).cpu()

    def _rank0_tokens(self, tok: torch.Tensor) -> torch.Tensor:
        """Rank 0's sampled tokens on every rank (a replicated backend at
        world n); records whether this rank's own differed."""
        if not self._replicated:
            return tok
        mesh = self.model.ctx.mesh
        got = tok.clone()
        dist.broadcast(got, src=dist.get_global_rank(mesh.group, 0),
                       group=mesh.group)
        self._differs.append((got != tok).any())
        return got

    @property
    def mega_tier(self) -> str | None:
        """The tier the dense decode step runs ("xla" | "pallas_chain"),
        None off the mega path."""
        return self._mega_rt.method.value if self._mega_rt else None

    def _init_kv_cache(self, bsz: int) -> None:
        # the cache is kept across serves of one batch size: the captured
        # step reads and writes its buffers by address
        kind = PagedKVCache if self.cache_mode == "paged" else KVCache
        if isinstance(self.kv_cache, kind) and self.kv_cache.batch == bsz:
            return
        if kind is PagedKVCache:
            self.kv_cache = self.model.create_paged_kv_cache(
                bsz, page_size=self.page_size, num_pages=self.num_pages,
                kv_resident=self.kv_resident)
        else:
            self.kv_cache = self.model.create_kv_cache(bsz)
        self._graph = None

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def _forward(self, ids: torch.Tensor) -> torch.Tensor:
        """One decode forward over self.kv_cache (written and advanced in
        place); returns the (B, V) f32 logits (this rank's B/n rows when
        the decode is batch-sharded)."""
        if self._sharded:
            mesh = self.model.ctx.mesh
            b = ids.shape[0] // mesh.world
            ids = ids[mesh.rank * b:(mesh.rank + 1) * b]
        if self._mega_rt is not None:
            step = self._mega_rt.dense_step_fn(self.mega_tier)
            logits, _ = step(self.params, self.kv_cache, ids)
        else:
            logits, _ = self.model.inference(self.params, self.kv_cache,
                                             ids, mode=self.backend)
        return logits

    def _build_decode_step(self) -> None:
        """Capture the decode step as a CUDA graph on a side stream: static
        token and cache buffers; one warm-up there first (it builds and
        loads every kernel and makes the stream's kernel workspaces, which
        must not happen under capture), its cache
        update undone afterwards (the offset, or the paged allocator's
        state; its K/V write lands where the first replay writes
        again)."""
        dev = self.model.device
        cache = self.kv_cache
        self._tok_buf = torch.zeros((cache.batch,), dtype=torch.int32,
                                    device=dev)
        saved = cache_state(cache)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._forward(self._tok_buf[:, None])
        torch.cuda.current_stream(dev).wait_stream(side)
        restore_cache_state(cache, saved)
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        with torch.cuda.graph(graph, stream=side):
            self._logits_buf = self._forward(self._tok_buf[:, None])
        after = launch_counts()
        self.graph_launches = {k: after[k] - before[k] for k in after}
        self._graph = graph

    def decode_logits(self, token: torch.Tensor) -> torch.Tensor:
        """ONE decode step without sampling: ``token`` is the (B,) pending
        token; returns the (B, V) f32 logits and advances self.kv_cache in
        place. On the card the result is the captured graph's output
        buffer, overwritten by the next step. A
        batch-sharded (triton_dist, n > 1) decode returns this rank's B/n
        rows."""
        if self.kv_cache is None:
            raise RuntimeError("no KV cache: call serve() (or prefill) "
                               "before stepping")
        ids = token[:, None]
        if self.model.device.type != "cuda":
            return self._dispatch(lambda: self._forward(ids))
        if self._graph is None:
            self._build_decode_step()
        self._tok_buf.copy_(token)
        self._dispatch(self._graph.replay)
        self.graph_replays += 1
        return self._logits_buf

    def _dispatch(self, launch):
        if self._mega_rt is not None:
            return self._mega_rt.dispatch(launch)
        return launch()

    def step(self, token: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """ONE decode step: ``token`` is the (B,) pending token; returns the
        (B,) next token and advances self.kv_cache in place. On the card
        the dense step is one CUDA-graph replay."""
        logits = self.decode_logits(token)
        nxt = sample_token(logits, generator, self.temperature, self.top_p)
        if not self._sharded:
            return self._rank0_tokens(nxt)
        mesh = self.model.ctx.mesh
        full = torch.empty((mesh.world * nxt.shape[0],), dtype=nxt.dtype,
                           device=nxt.device)
        dist.all_gather_into_tensor(full, nxt.contiguous(), group=mesh.group)
        return full

    def serve(self, input_ids: torch.Tensor, gen_len: int,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Prefill + gen_len - 1 decode steps; returns (B, gen_len) int32
        token ids. ``generator`` drives sampling when temperature > 0.
        The length check comes first, so no step reads the cache offset
        back to the host."""
        input_ids = torch.as_tensor(input_ids, device=self.model.device)
        bsz, t = input_ids.shape
        if self._sharded and bsz % self.model.ctx.world:
            raise ValueError(
                f"batch {bsz} not divisible by the world "
                f"{self.model.ctx.world}: the triton_dist decode gives "
                "every rank B/n rows")
        if t + gen_len > self.model.max_length:
            raise ValueError(
                f"prefill {t} + gen_len {gen_len} exceeds the model's "
                f"max_length {self.model.max_length}")
        self._init_kv_cache(bsz)
        self.kv_cache.clear()
        self.graph_replays = 0
        self._differs = []
        if self.verbose:
            self.logger.log(
                f"serve: prefill {tuple(input_ids.shape)}, gen_len={gen_len}"
                f", backend={self.backend}, cache={self.cache_mode}"
                + (f", mega {self.mega_tier}" if self._mega_rt else ""))

        t0 = time.perf_counter()
        logits, self.kv_cache = self.model.inference(
            self.params, self.kv_cache, input_ids, mode="xla")
        next_token = self._rank0_tokens(sample_token(
            logits, generator, self.temperature, self.top_p))
        self._sync()
        self.last_prefill_s = time.perf_counter() - t0

        outputs = [next_token]
        t0 = time.perf_counter()
        for _ in range(gen_len - 1):
            next_token = self.step(next_token, generator)
            outputs.append(next_token)
        out = torch.stack(outputs, dim=1)
        self._sync()
        dt = time.perf_counter() - t0
        check_overflow(self.model.device)     # EP pairs dropped in replays
        self.last_decode_s = dt
        self.last_decode_steps = gen_len - 1
        if self.verbose and gen_len > 1:
            self.logger.log(
                f"decode: {gen_len - 1} steps in {dt:.3f}s "
                f"({(gen_len - 1) * bsz / max(dt, 1e-9):.1f} tok/s)")
        return out


_PAGED_STATE = ("block_table", "lengths", "free_stack", "next_free",
                "overflow", "ref_count")


def cache_state(cache) -> dict:
    """A copy of what a decode step changes in ``cache`` besides the K/V
    it writes past the rows' lengths: the dense offset, or the paged
    allocator's tensors."""
    names = (_PAGED_STATE if isinstance(cache, PagedKVCache)
             else ("offset",))
    return {n: getattr(cache, n).clone() for n in names}


def restore_cache_state(cache, saved: dict) -> None:
    """Put back ``cache_state``'s copy, in place."""
    for n, t in saved.items():
        getattr(cache, n).copy_(t)
