"""ModelBuilder: record a decode step as a task graph and compile it into
one step function (the reference's mega/builder.py).

``make_*`` methods record Tasks whose base function is the plain PyTorch
op of the layer-by-layer path (the "xla" tier: the same ops in the same
order, so the tier is bit-identical to ``Qwen3.inference``) and, for the
fused tasks, a "pallas_chain" function that launches the hand-written
kernels (B3 fused add+RMSNorm, B4 GEMM+AR). ``compile`` validates a
schedule and returns a plain Python function that runs the tasks in that
order; on the card the engine captures one call of it as a CUDA graph.

Tasks are per-device ops of one rank; the builder holds the ranks' mesh
(None at world 1, where the reference's psum is the identity) for the
tasks that sum over the ranks. The KV writes are in place (the dense
cache slabs and the paged pools are views of the cache). The paged
attend runs B2 and the LSE merge in every tier, as in the reference; its
speculative-verify form (``make_paged_attend_spec``) waits for ROADMAP
A12, the per-task flight spans for A8.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from triton_dist_tpu_torch.layers.attention_core import gqa_attend
from triton_dist_tpu_torch.layers.common import apply_rope, rms_norm
from triton_dist_tpu_torch.layers.tp_attn import write_kv_slabs
from triton_dist_tpu_torch.layers.tp_mlp import _silu_mul
from triton_dist_tpu_torch.mega.scheduler import schedule_tasks
from triton_dist_tpu_torch.mega.task import TaskGraph


class ModelBuilder:
    """Records tasks into a TaskGraph; names are the step's tensor env.
    ``mesh``: the ranks' Mesh of the tasks that sum over them (the
    reference's mesh axis); None at world 1."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.graph = TaskGraph()
        self.inputs: list[str] = []
        self.outputs: list[str] = []
        self._uid = 0

    # -- naming -----------------------------------------------------------

    def _name(self, kind: str) -> str:
        self._uid += 1
        return f"{kind}_{self._uid}"

    def add_input(self, name: str) -> str:
        """Declare a step input (activation, weight, cache slab, scalar)."""
        if name in self.inputs:
            raise ValueError(f"duplicate input {name}")
        self.inputs.append(name)
        return name

    def mark_output(self, *names: str) -> None:
        """Declare step outputs: each must be produced by a task or be a
        declared input, and be marked once."""
        for name in names:
            if name not in self.graph.producer and name not in self.inputs:
                raise ValueError(
                    f"cannot mark unknown tensor {name!r} as output: no "
                    "task produces it and it is not a declared input")
            if name in self.outputs:
                raise ValueError(f"duplicate output {name!r}")
            self.outputs.append(name)

    def _add(self, kind: str, layer_id: int, ins: Sequence[str],
             fn: Callable, n_out: int = 1, tier_fns: dict | None = None,
             is_comm: bool = False):
        outs = tuple(self._name(kind) for _ in range(n_out))
        self.graph.add(kind, layer_id, tuple(ins), outs, fn, tier_fns,
                       is_comm)
        return outs[0] if n_out == 1 else outs

    # -- task kinds -------------------------------------------------------

    def make_embedding(self, ids: str, table: str, *, layer_id: int = -1,
                       dtype: torch.dtype = torch.bfloat16) -> str:
        return self._add("embedding", layer_id, (ids, table),
                         lambda i, t: t[i].to(dtype))

    def make_rms_norm(self, x: str, w: str, eps: float = 1e-6, *,
                      layer_id: int) -> str:
        return self._add("rms_norm", layer_id, (x, w),
                         lambda x_, w_: rms_norm(x_, w_, eps))

    def make_linear(self, x: str, w: str, *, layer_id: int) -> str:
        """x @ w in x's dtype (f32 accumulation inside the GEMM)."""
        return self._add("linear", layer_id, (x, w), torch.matmul)

    def make_qkv_proj(self, x: str, w: str, q_size: int, kv_size: int, *,
                      layer_id: int):
        """Fused QKV projection + split."""
        def fn(x_, w_):
            qkv = torch.matmul(x_, w_)
            return tuple(torch.split(qkv, [q_size, kv_size, kv_size],
                                     dim=-1))
        return self._add("qkv_proj", layer_id, (x, w), fn, n_out=3)

    def make_qk_norm_rope(self, q: str, k: str, q_norm: str, k_norm: str,
                          cos_sin: str, positions: str, num_q_heads: int,
                          num_kv_heads: int, head_dim: int,
                          eps: float = 1e-6, *, layer_id: int):
        """Per-head QK RMSNorm + rotary."""
        def fn(q_, k_, qn, kn, cs, pos):
            b, t = q_.shape[0], q_.shape[1]
            qh = q_.reshape(b, t, num_q_heads, head_dim)
            kh = k_.reshape(b, t, num_kv_heads, head_dim)
            qh = rms_norm(qh, qn, eps)
            kh = rms_norm(kh, kn, eps)
            return apply_rope(qh, kh, cs, pos)
        return self._add("qk_norm_rope", layer_id,
                         (q, k, q_norm, k_norm, cos_sin, positions), fn,
                         n_out=2)

    def make_kv_update(self, k: str, v: str, k_cache: str, v_cache: str,
                       offset: str, *, layer_id: int):
        """Write this step's (B, T, Hkv, D) K/V into the layer's slabs at
        ``offset``, IN PLACE; returns the (updated) slabs."""
        def fn(k_, v_, kc, vc, off):
            write_kv_slabs(kc, vc, k_, v_, off)
            return kc, vc
        return self._add("kv_update", layer_id,
                         (k, v, k_cache, v_cache, offset), fn, n_out=2)

    def make_attn(self, q: str, k_cache: str, v_cache: str, offset: str, *,
                  layer_id: int) -> str:
        """GQA attention over the padded cache; q is the rope'd
        (B, T, Hq, D) tensor."""
        def fn(q_, kc, vc, off):
            b, t = q_.shape[0], q_.shape[1]
            out = gqa_attend(q_, kc, vc, off, t)
            return out.reshape(b, t, -1)
        return self._add("attn", layer_id, (q, k_cache, v_cache, offset), fn)

    def make_paged_kv_write(self, k: str, v: str, k_pages: str,
                            v_pages: str, table: str, lengths: str,
                            active: str, page_size: int, *, layer_id: int,
                            k_scales: str | None = None,
                            v_scales: str | None = None):
        """Write this step's (B, T, Hkv, D) K/V into the layer's paged
        pool slabs IN PLACE (False ``active`` rows write nothing): the
        write half of the layer path's paged_attn_fwd, through the same
        paged_write_layer. With scale slab names the pool is int8-resident
        (each row encoded once) and the task returns the scale slabs too
        (n_out=4)."""
        from triton_dist_tpu_torch.models.kv_cache import paged_write_layer

        if k_scales is not None:
            def fn_q(k_, v_, kp, vp, kps, vps, tb, ln, ac):
                paged_write_layer(tb, ln, page_size, kp, vp, k_, v_,
                                  active=ac, layer_k_scales=kps,
                                  layer_v_scales=vps)
                return kp, vp, kps, vps
            return self._add("paged_kv_write", layer_id,
                             (k, v, k_pages, v_pages, k_scales, v_scales,
                              table, lengths, active), fn_q, n_out=4)

        def fn(k_, v_, kp, vp, tb, ln, ac):
            paged_write_layer(tb, ln, page_size, kp, vp, k_, v_, active=ac)
            return kp, vp
        return self._add("paged_kv_write", layer_id,
                         (k, v, k_pages, v_pages, table, lengths, active),
                         fn, n_out=2)

    def make_paged_attend(self, q: str, k_pages: str, v_pages: str,
                          table: str, lengths: str, dtype, *, layer_id: int,
                          k_scales: str | None = None,
                          v_scales: str | None = None) -> str:
        """T=1 paged GQA flash decode over the block table (B2's split-KV
        partials, then the row-wise LSE merge): the T == 1 branch of
        paged_attn_fwd, in every tier. q is the rope'd (B, 1, Hq, D)
        tensor; returns (B, 1, Hq, D)."""
        from triton_dist_tpu_torch.kernels.flash_decode import lse_merge
        from triton_dist_tpu_torch.kernels.paged_flash_decode import (
            paged_flash_decode_partial,
        )

        def attend(q_, kp, vp, tb, ln, kps=None, vps=None):
            acc, m, l = paged_flash_decode_partial(
                q_[:, 0].contiguous(), kp, vp, tb, ln + 1, k_scales=kps,
                v_scales=vps)
            return lse_merge(acc[None], m[None], l[None])[:, None].to(dtype)

        if k_scales is not None:
            def fn_q(q_, kp, vp, kps, vps, tb, ln):
                return attend(q_, kp, vp, tb, ln, kps, vps)
            return self._add("paged_attend", layer_id,
                             (q, k_pages, v_pages, k_scales, v_scales,
                              table, lengths), fn_q)
        return self._add("paged_attend", layer_id,
                         (q, k_pages, v_pages, table, lengths), attend)

    def make_silu_mul(self, gate_up: str, *, layer_id: int) -> str:
        return self._add("silu_mul", layer_id, (gate_up,), _silu_mul)

    def make_add(self, a: str, b: str, *, layer_id: int) -> str:
        """Residual add."""
        return self._add("add", layer_id, (a, b), lambda x, y: x + y)

    def mesh_of(self, world: int):
        """The mesh a task of ``world`` ranks runs on: None at world 1;
        at n > 1 the builder's mesh, which must span n ranks. Checked when
        the task runs, so a graph of any world can be recorded (and
        scheduled) without a process group."""
        if world == 1:
            return None
        if self.mesh is None or self.mesh.world != world:
            raise ValueError(f"a task of world {world} runs on the mesh of "
                             f"its {world} ranks; the builder has "
                             f"{self.mesh}")
        return self.mesh

    def psum(self, x: torch.Tensor, world: int) -> torch.Tensor:
        """The reference's psum over the builder's mesh: an in-place
        all-reduce of ``x`` over ``world`` ranks (the identity at 1)."""
        mesh = self.mesh_of(world)
        if mesh is not None:
            dist.all_reduce(x, group=mesh.group)
        return x

    def make_allreduce(self, x: str, *, layer_id: int,
                       world: int = 1) -> str:
        """TP sum (the reference's make_allreduce: its psum over the mesh
        axis) as one comm task."""
        return self._add("allreduce", layer_id, (x,),
                         lambda x_: self.psum(x_.clone(), world),
                         is_comm=True)

    def make_linear_allreduce(self, x: str, w: str, *, layer_id: int,
                              world: int = 1, gemm_ar_method=None) -> str:
        """Row-parallel projection + TP sum as ONE task. The xla tier is
        the layer path's GEMM in x's dtype, then the process group's
        all-reduce of that cast product (the identity at world 1); the
        pallas_chain tier dispatches gemm_ar_per_device (B4 under AUTO on
        the card: f32 partials summed over the ranks, then the cast)."""

        def xla_fn(x_, w_):
            return self.psum(torch.matmul(x_, w_).to(x_.dtype), world)

        def fused_fn(x_, w_):
            from triton_dist_tpu_torch.kernels.gemm_allreduce import (
                GemmArMethod, gemm_ar_per_device,
            )
            method = gemm_ar_method or GemmArMethod.AUTO
            shape = x_.shape
            y2d = gemm_ar_per_device(world, method,
                                     x_.reshape(-1, shape[-1]), w_,
                                     mesh=self.mesh_of(world))
            return y2d.reshape(shape[:-1] + (w_.shape[-1],)).to(x_.dtype)

        return self._add("linear_allreduce", layer_id, (x, w), xla_fn,
                         tier_fns={"pallas_chain": fused_fn}, is_comm=True)

    def make_fused_chain(self, h: str, a: str, w: str,
                         eps: float = 1e-6, *, layer_id: int):
        """The attention→MLP boundary as one task: residual add + the
        following RMSNorm. xla tier: the plain fold (add_rms_norm_xla);
        pallas_chain tier: the fused kernel (B3). Returns (h_new,
        normed)."""
        from triton_dist_tpu_torch.kernels.fused_chain import (
            FusedChainMethod, add_rms_norm_xla, fused_add_rms_per_device,
        )

        def xla_fn(h_, a_, w_):
            return add_rms_norm_xla(h_, a_, w_, eps)

        def pallas_fn(h_, a_, w_):
            return fused_add_rms_per_device(FusedChainMethod.PALLAS, h_, a_,
                                            w_, eps)

        return self._add("fused_chain", layer_id, (h, a, w), xla_fn,
                         n_out=2, tier_fns={"pallas_chain": pallas_fn})

    def make_custom(self, kind: str, ins: Sequence[str], fn: Callable,
                    n_out: int = 1, *, layer_id: int, is_comm: bool = False,
                    tier_fns: dict | None = None):
        """Escape hatch for ops without a dedicated task kind; ``tier_fns``
        maps a tier to the task's function there (the base fn elsewhere)."""
        return self._add(kind, layer_id, ins, fn, n_out=n_out,
                         tier_fns=tier_fns, is_comm=is_comm)

    # -- compile ----------------------------------------------------------

    def compile(self, policy: str = "program", tier: str | None = None):
        """Validate the schedule and return step(env) -> {output: tensor},
        running every task in schedule order on ``tier`` (None/"xla": the
        base fns; "pallas_chain": the kernel fns where a task has one)."""
        order = schedule_tasks(self.graph, policy)
        tasks = self.graph.tasks
        inputs, outputs = list(self.inputs), list(self.outputs)
        if not outputs:
            raise ValueError("no outputs marked")

        def step(env: dict) -> dict:
            env = dict(env)
            missing = [n for n in inputs if n not in env]
            if missing:
                raise KeyError(f"missing step inputs: {missing}")
            for tid in order:
                t = tasks[tid]
                vals = t.fn_for(tier)(*(env[n] for n in t.inputs))
                if len(t.outputs) == 1:
                    vals = (vals,)
                env.update(zip(t.outputs, vals))
            return {n: env[n] for n in outputs}

        return step

    def metrics(self) -> dict:
        return self.graph.metrics()
