"""The port's layers against the JAX package, in f32 on the CPU.

The JAX layer functions are per-device code (their psum needs a mesh
axis), so they run under a one-device shard_map. Tolerance: f32 on both
sides, same operation order up to library summation order:
atol = rtol = 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conftest import needs_interpreter
from triton_dist_tpu.layers import TPContext as JaxTPContext
from triton_dist_tpu.layers.attention_core import (
    gqa_attend_xla as jax_gqa_attend_xla,
)
from triton_dist_tpu.layers.common import apply_rope as jax_apply_rope
from triton_dist_tpu.layers.common import (
    make_cos_sin_cache as jax_make_cos_sin_cache,
)
from triton_dist_tpu.layers.common import rms_norm as jax_rms_norm
from triton_dist_tpu.layers.tp_attn import attn_fwd as jax_attn_fwd
from triton_dist_tpu.layers.tp_attn import paged_attn_fwd as jax_paged_attn
from triton_dist_tpu.layers.tp_mlp import mlp_fwd as jax_mlp_fwd
from triton_dist_tpu.models.config import Qwen3Arch as JaxQwen3Arch
from triton_dist_tpu.runtime import make_comm_mesh
from triton_dist_tpu.runtime.compat import td_shard_map

from triton_dist_tpu_torch.kernels.allreduce import AllReduceMethod
from triton_dist_tpu_torch.kernels.gemm_allreduce import GemmArMethod
from triton_dist_tpu_torch.layers.attention_core import (
    _use_flash, gqa_attend_xla,
)
from triton_dist_tpu_torch.layers.common import (
    TPContext, apply_rope, make_cos_sin_cache, rms_norm,
)
from triton_dist_tpu_torch.layers.tp_attn import attn_fwd, paged_attn_fwd
from triton_dist_tpu_torch.layers.tp_mlp import mlp_fwd
from triton_dist_tpu_torch.models.config import Qwen3Arch

TOL = dict(atol=1e-5, rtol=1e-5)
ARCH_KW = dict(vocab_size=64, hidden_size=256, intermediate_size=512,
               num_layers=1, num_heads=4, num_kv_heads=2, head_dim=128)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mesh1():
    return make_comm_mesh(axes=[("tp", 1)], devices=jax.devices()[:1])


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 128), np.float32) * 3
    w = rng.standard_normal((128,), np.float32)
    np.testing.assert_allclose(
        rms_norm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        **TOL)
    # bf16: normalized in f32, cast to bf16, THEN scaled by w
    xb = _t(x).to(torch.bfloat16)
    wb = _t(w).to(torch.bfloat16)
    got = rms_norm(xb, wb, 1e-6)
    assert got.dtype == torch.bfloat16
    want = (xb.float() * torch.rsqrt(xb.float().pow(2).mean(-1, True)
                                     + 1e-6)).to(torch.bfloat16) * wb
    assert torch.equal(got, want)


@pytest.mark.parametrize("ragged", [False, True])
def test_rope_matches_jax(ragged):
    rng = np.random.default_rng(1)
    b, t, d = 2, 6, 128
    cs = make_cos_sin_cache(d, 160, 1_000_000.0)
    jcs = jax_make_cos_sin_cache(d, 160, 1_000_000.0)
    np.testing.assert_allclose(cs.numpy(), np.asarray(jcs), **TOL)
    q = rng.standard_normal((b, t, 4, d), np.float32)
    k = rng.standard_normal((b, t, 2, d), np.float32)
    if ragged:
        pos = np.array([[0, 1, 2, 3, 4, 5], [130, 131, 132, 133, 134, 135]],
                       np.int32)
    else:
        pos = np.arange(150, 150 + t, dtype=np.int32)
    qt, kt = apply_rope(_t(q), _t(k), cs, _t(pos))
    qj, kj = jax_apply_rope(jnp.asarray(q), jnp.asarray(k), jcs,
                            jnp.asarray(pos))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), **TOL)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), **TOL)


def test_mlp_fwd_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 256), np.float32)
    w = {"w_gate_up": rng.standard_normal((256, 1024), np.float32) / 16,
         "w_down": rng.standard_normal((512, 256), np.float32) / 16}
    got = mlp_fwd("xla", TPContext(), {k: _t(v) for k, v in w.items()},
                  _t(x))
    mesh = _mesh1()
    ctx = JaxTPContext(mesh, "tp")
    fn = td_shard_map(lambda w_, x_: jax_mlp_fwd("xla", ctx, w_, x_),
                      mesh=mesh, in_specs=(P(), P()), out_specs=P())
    want = fn({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # triton_dist (AG + GEMM / GEMM + RS, identities at world 1) and
    # triton_dist_AR (its all-reduce and fused GEMM + all-reduce,
    # identities at world 1) compute the same block
    td = mlp_fwd("triton_dist", TPContext(), {k: _t(v) for k, v in w.items()},
                 _t(x))
    np.testing.assert_allclose(td.numpy(), np.asarray(want), **TOL)
    for ctx in (TPContext(), TPContext(ar_method=AllReduceMethod.ONE_SHOT),
                TPContext(gemm_ar_method=GemmArMethod.PALLAS)):
        ar = mlp_fwd("triton_dist_AR", ctx,
                     {k: _t(v) for k, v in w.items()}, _t(x))
        np.testing.assert_allclose(ar.numpy(), np.asarray(want), **TOL)


def _layer_weights(rng):
    a = Qwen3Arch(**ARCH_KW)
    d = a.hidden_size
    return {
        "wqkv": rng.standard_normal((d, a.q_size + 2 * a.kv_size),
                                    np.float32) / 16,
        "wo": rng.standard_normal((a.q_size, d), np.float32) / 16,
        "q_norm": rng.uniform(0.5, 1.5, (a.head_dim,)).astype(np.float32),
        "k_norm": rng.uniform(0.5, 1.5, (a.head_dim,)).astype(np.float32),
    }


@needs_interpreter()
@pytest.mark.parametrize("attn_method", ["auto", "xla"])
def test_paged_attn_fwd_prefill_then_decode_matches_jax(attn_method):
    """Prefill (T=128: the flash kernel under "auto", the einsum under
    "xla") into empty pages, one decode step over the written pages (B2),
    then a continuation chunk of one row over its pages: outputs and pools
    match the JAX layer."""
    rng = np.random.default_rng(3)
    arch, jarch = Qwen3Arch(**ARCH_KW), JaxQwen3Arch(**ARCH_KW)
    w = _layer_weights(rng)
    b, t, ps, num_pages = 2, 128, 32, 12
    table = np.array([[5, 2, 9, 0, 7], [1, 11, 3, 8, 4]], np.int32)
    hkv, d = arch.num_kv_heads, arch.head_dim
    x = rng.standard_normal((b, t, arch.hidden_size), np.float32)
    x1 = rng.standard_normal((b, 1, arch.hidden_size), np.float32)
    cs = make_cos_sin_cache(d, 160, arch.rope_theta)
    jcs = jax_make_cos_sin_cache(d, 160, arch.rope_theta)

    lk = torch.zeros((hkv, num_pages, ps, d))
    lv = torch.zeros((hkv, num_pages, ps, d))
    ctx = TPContext(attn_method=attn_method)
    mesh = _mesh1()
    jctx = JaxTPContext(mesh, "tp", attn_method=attn_method)
    tw = {k: _t(v) for k, v in w.items()}
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    jlk = jnp.zeros((hkv, num_pages, ps, d))
    jlv = jnp.zeros((hkv, num_pages, ps, d))

    def jax_layer(w_, x_, pos_, lk_, lv_, tab_, len_):
        return jax_paged_attn("xla", jctx, jarch, w_, x_, pos_, jcs, lk_, lv_,
                              tab_, len_, ps)

    jfn = jax.jit(td_shard_map(jax_layer, mesh=mesh, in_specs=(P(),) * 7,
                               out_specs=(P(), P(), P())))
    for xin, start in ((x, 0), (x1, t)):
        lengths = np.full((b,), start, np.int32)
        pos = lengths[:, None] + np.arange(xin.shape[1], dtype=np.int32)
        y = paged_attn_fwd("xla", ctx, arch, tw, _t(xin), _t(pos), cs, lk,
                           lv, _t(table), _t(lengths), ps)
        jy, jlk, jlv = jfn(jw, jnp.asarray(xin), jnp.asarray(pos), jlk, jlv,
                           jnp.asarray(table), jnp.asarray(lengths))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(lk.numpy(), np.asarray(jlk), **TOL)
        np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), **TOL)
    # a continuation chunk of row 0 (T=16 at offset 129): it attends the
    # row's pages in logical order, this chunk's keys included (B1 at a
    # device offset under "auto")
    x2 = rng.standard_normal((1, 16, arch.hidden_size), np.float32)
    len2 = np.array([t + 1], np.int32)
    pos2 = len2[:, None] + np.arange(16, dtype=np.int32)
    y = paged_attn_fwd("xla", ctx, arch, tw, _t(x2), _t(pos2), cs, lk, lv,
                       _t(table[:1]), _t(len2), ps, continuation=True)

    def jax_cont(w_, x_, pos_, lk_, lv_, tab_, len_):
        return jax_paged_attn("xla", jctx, jarch, w_, x_, pos_, jcs, lk_,
                              lv_, tab_, len_, ps, continuation=True)

    jy, jlk, jlv = jax.jit(td_shard_map(
        jax_cont, mesh=mesh, in_specs=(P(),) * 7,
        out_specs=(P(), P(), P())))(jw, jnp.asarray(x2), jnp.asarray(pos2),
                                    jlk, jlv, jnp.asarray(table[:1]),
                                    jnp.asarray(len2))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(lk.numpy(), np.asarray(jlk), **TOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), **TOL)


@needs_interpreter()
@pytest.mark.parametrize("attn_method", ["auto", "xla"])
def test_attn_fwd_dense_prefill_then_decode_matches_jax(attn_method):
    """Over the dense cache: prefill (T=128 at offset 0: the flash kernel
    under "auto", the einsum under "xla") then one decode step at offset
    128 (T=1 over S=160 keys: flash again under "auto"); outputs and slabs
    match the JAX layer, the offset being a 0-d tensor on the device."""
    rng = np.random.default_rng(5)
    arch, jarch = Qwen3Arch(**ARCH_KW), JaxQwen3Arch(**ARCH_KW)
    w = _layer_weights(rng)
    b, t, s_len = 2, 128, 160
    hkv, d = arch.num_kv_heads, arch.head_dim
    x = rng.standard_normal((b, t, arch.hidden_size), np.float32)
    x1 = rng.standard_normal((b, 1, arch.hidden_size), np.float32)
    cs = make_cos_sin_cache(d, s_len, arch.rope_theta)
    jcs = jax_make_cos_sin_cache(d, s_len, arch.rope_theta)
    lk = torch.zeros((b, s_len, hkv, d))
    lv = torch.zeros((b, s_len, hkv, d))
    jlk = jnp.zeros((b, s_len, hkv, d))
    jlv = jnp.zeros((b, s_len, hkv, d))
    ctx = TPContext(attn_method=attn_method)
    mesh = _mesh1()
    jctx = JaxTPContext(mesh, "tp", attn_method=attn_method)
    tw = {k: _t(v) for k, v in w.items()}
    jw = {k: jnp.asarray(v) for k, v in w.items()}

    def jax_layer(w_, x_, pos_, lk_, lv_, off_):
        return jax_attn_fwd("xla", jctx, jarch, w_, x_, pos_, jcs, lk_, lv_,
                            off_)

    jfn = jax.jit(td_shard_map(jax_layer, mesh=mesh, in_specs=(P(),) * 6,
                               out_specs=(P(), P(), P())))
    for xin, start in ((x, 0), (x1, t)):
        off = torch.tensor(start, dtype=torch.int32)
        pos = off + torch.arange(xin.shape[1])
        y = attn_fwd("xla", ctx, arch, tw, _t(xin), pos, cs, lk, lv, off)
        jy, jlk, jlv = jfn(jw, jnp.asarray(xin), jnp.asarray(pos.numpy()),
                           jlk, jlv, jnp.asarray(start, jnp.int32))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(lk.numpy(), np.asarray(jlk), **TOL)
        np.testing.assert_allclose(lv.numpy(), np.asarray(jlv), **TOL)


def test_gqa_attend_xla_and_flash_choice_match_jax():
    from triton_dist_tpu.layers.attention_core import _use_flash as jax_uf
    for method in ("auto", "pallas", "xla"):
        for d, s in ((32, 12), (128, 127), (128, 128), (64, 512)):
            assert _use_flash(method, d, s) == jax_uf(method, d, s)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 5, 4, 32), np.float32)
    k = rng.standard_normal((2, 9, 2, 32), np.float32)
    v = rng.standard_normal((2, 9, 2, 32), np.float32)
    np.testing.assert_allclose(
        gqa_attend_xla(_t(q), _t(k), _t(v), 4, 5).numpy(),
        np.asarray(jax_gqa_attend_xla(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), 4, 5)), **TOL)
