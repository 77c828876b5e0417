"""Inference Engine on the paged KV cache (the reference's models/engine.py).

``serve`` prefills the prompt (flash prefill, B1, through every layer) and
then runs gen_len - 1 decode steps (paged flash decode, B2, through every
layer), one eager PyTorch step per token. The reference's dense cache and
its mega decode program (``cache_mode="dense"``) wait for ROADMAP A3/A7,
speculative decode for A12; as in the reference, ``mega`` is ignored on
the paged cache. The decode step as a CUDA-graph replay waits for ROADMAP A6.
"""

from __future__ import annotations

import time

import torch

from triton_dist_tpu_torch.layers.common import check_mode
from triton_dist_tpu_torch.models.kv_cache import PagedKVCache
from triton_dist_tpu_torch.models.utils import logger, sample_token


class Engine:

    def __init__(self, model, params: dict, temperature: float = 0.0,
                 top_p: float = 1.0, backend: str = "xla",
                 cache_mode: str = "paged", page_size: int = 128,
                 num_pages: int | None = None,
                 kv_resident: str | None = None, mega: str = "auto",
                 spec: str = "off", verbose: bool = False):
        if cache_mode == "dense":
            raise NotImplementedError(
                "cache_mode='dense' (dense KVCache + mega decode program) "
                "waits for ROADMAP A3/A7; use cache_mode='paged'")
        if cache_mode != "paged":
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if spec != "off":
            raise NotImplementedError(
                "speculative decode waits for ROADMAP A12")
        check_mode(backend)
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
        self.mega = mega          # ignored on the paged cache, as upstream
        self.verbose = verbose
        self.kv_cache: PagedKVCache | None = None
        self.logger = logger
        self.last_prefill_s = 0.0         # timings of the last serve
        self.last_decode_s = 0.0
        self.last_decode_steps = 0

    def _init_kv_cache(self, bsz: int) -> None:
        self.kv_cache = self.model.create_paged_kv_cache(
            bsz, page_size=self.page_size, num_pages=self.num_pages,
            kv_resident=self.kv_resident)

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def step(self, token: torch.Tensor,
             generator: torch.Generator | None = None) -> torch.Tensor:
        """ONE decode step: ``token`` is the (B,) pending token; returns the
        (B,) next token and advances self.kv_cache in place."""
        if self.kv_cache is None:
            raise RuntimeError("no KV cache: call serve() (or prefill) "
                               "before stepping")
        logits, self.kv_cache = self.model.inference(
            self.params, self.kv_cache, token[:, None], mode=self.backend)
        return sample_token(logits, generator, self.temperature, self.top_p)

    def serve(self, input_ids: torch.Tensor, gen_len: int,
              generator: torch.Generator | None = None) -> torch.Tensor:
        """Prefill + gen_len - 1 decode steps; returns (B, gen_len) int32
        token ids. ``generator`` drives sampling when temperature > 0."""
        input_ids = torch.as_tensor(input_ids, device=self.model.device)
        bsz, t = input_ids.shape
        if t + gen_len > self.model.max_length:
            raise ValueError(
                f"prefill {t} + gen_len {gen_len} exceeds the model's "
                f"max_length {self.model.max_length}")
        self._init_kv_cache(bsz)
        self.kv_cache.clear()
        if self.verbose:
            self.logger.log(f"serve: prefill {tuple(input_ids.shape)}, "
                            f"gen_len={gen_len}, backend={self.backend}")

        t0 = time.perf_counter()
        logits, self.kv_cache = self.model.inference(
            self.params, self.kv_cache, input_ids, mode="xla")
        next_token = sample_token(logits, generator, self.temperature,
                                  self.top_p)
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
        self.last_decode_s = dt
        self.last_decode_steps = gen_len - 1
        if self.verbose and gen_len > 1:
            self.logger.log(
                f"decode: {gen_len - 1} steps in {dt:.3f}s "
                f"({(gen_len - 1) * bsz / max(dt, 1e-9):.1f} tok/s)")
        return out
