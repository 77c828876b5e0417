"""The port's kernel modules against the JAX package, on the CPU.

On CPU tensors the port's wrappers run their plain PyTorch versions; the
JAX side runs its Pallas kernels in interpret mode. Inputs are made with
numpy from a seed and handed to both. Tolerances: f32 on both sides, the
same fold order, so agreement is to float rounding (atol = rtol = 1e-5);
integer outputs (int8 codes, table clamps) must be bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.sharding import PartitionSpec as P

from conftest import needs_interpreter
from triton_dist_tpu.kernels.flash_attention import flash_prefill as jax_fp
from triton_dist_tpu.kernels.flash_decode import lse_merge as jax_lse_merge
from triton_dist_tpu.kernels.flash_decode import (
    lse_partial_merge as jax_lse_partial_merge,
)
from triton_dist_tpu.kernels.fused_chain import (
    FusedChainMethod as JaxFusedChainMethod,
)
from triton_dist_tpu.kernels.fused_chain import (
    add_rms_norm_xla as jax_add_rms_norm_xla,
)
from triton_dist_tpu.kernels.fused_chain import (
    fused_add_rms_per_device as jax_fused_add_rms,
)
from triton_dist_tpu.kernels.gemm_allreduce import (
    GemmArMethod as JaxGemmArMethod,
)
from triton_dist_tpu.kernels.gemm_allreduce import (
    gemm_ar_per_device as jax_gemm_ar_per_device,
)
from triton_dist_tpu.kernels.paged_flash_decode import (
    paged_flash_decode_partial as jax_pfd,
)
from triton_dist_tpu.models.kv_cache import (
    paged_write_layer as jax_paged_write_layer,
)
from triton_dist_tpu.quant.codec import kv_row_decode as jax_kv_row_decode
from triton_dist_tpu.quant.codec import kv_row_encode as jax_kv_row_encode
from triton_dist_tpu.runtime import make_comm_mesh
from triton_dist_tpu.runtime.compat import td_shard_map

from triton_dist_tpu_torch.kernels.flash_attention import (
    flash_prefill, flash_prefill_ref,
)
from triton_dist_tpu_torch.kernels.flash_decode import (
    lse_merge, lse_partial_merge,
)
from triton_dist_tpu_torch.kernels.fused_chain import (
    FusedChainMethod, add_rms_norm_xla, fused_add_rms,
    fused_add_rms_per_device,
)
from triton_dist_tpu_torch.kernels.gemm_allreduce import (
    GemmArMethod, gemm_ar, gemm_ar_per_device, gemm_ar_ref, split_plan,
)
from triton_dist_tpu_torch.kernels.paged_flash_decode import (
    paged_flash_decode, paged_flash_decode_partial,
)
from triton_dist_tpu_torch.models.kv_cache import PagedKVCache
from triton_dist_tpu_torch.models.kv_cache import paged_write_layer
from triton_dist_tpu_torch.quant.codec import kv_row_decode, kv_row_encode

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@needs_interpreter()
@pytest.mark.parametrize("t,offset", [(128, 0), (130, 0), (128, 64),
                                      (130, 70)])
def test_flash_prefill_ref_matches_jax(t, offset):
    """B1's plain version vs the JAX kernel (interpret mode): the ragged
    tail block (T=130) and a query offset with S = offset + T > T."""
    rng = np.random.default_rng(t + offset)
    b, hq, hkv, d = 2, 4, 2, 128
    s = offset + t
    q = rng.standard_normal((b, t, hq, d), np.float32)
    k = rng.standard_normal((b, s, hkv, d), np.float32)
    v = rng.standard_normal((b, s, hkv, d), np.float32)
    want = np.asarray(jax_fp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(offset, jnp.int32)))
    got = flash_prefill(_t(q), _t(k), _t(v), offset)
    assert got.dtype == torch.float32 and got.shape == (b, t, hq, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the wrapper's CPU path IS the plain version
    np.testing.assert_array_equal(
        got.numpy(), flash_prefill_ref(_t(q), _t(k), _t(v), offset).numpy())


def test_flash_prefill_ref_takes_a_device_offset():
    """B1's plain version with the offset as a 0-d int32 tensor (the dense
    cache's on-device offset) gives what the int offset gives, which the
    JAX einsum attention gives too (T = 1, the dense decode form)."""
    rng = np.random.default_rng(9)
    b, hq, hkv, d, s, off = 2, 4, 2, 128, 160, 70
    q = _t(rng.standard_normal((b, 1, hq, d), np.float32))
    k = _t(rng.standard_normal((b, s, hkv, d), np.float32))
    v = _t(rng.standard_normal((b, s, hkv, d), np.float32))
    want = flash_prefill_ref(q, k, v, off)
    got = flash_prefill(q, k, v, torch.tensor(off, dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    from triton_dist_tpu.layers.attention_core import (
        gqa_attend_xla as jax_gqa_attend_xla,
    )
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_gqa_attend_xla(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
            jnp.asarray(v.numpy()), jnp.asarray(off, jnp.int32), 1)),
        **TOL)


@needs_interpreter()
def test_fused_add_rms_ref_matches_jax():
    """B3's plain version against the JAX twin and the JAX kernel in
    interpret mode, f32: s exact, normed within 1e-6. The wrapper's CPU
    path and the PALLAS method ARE the plain version."""
    rng = np.random.default_rng(10)
    h = rng.standard_normal((4, 1, 256), np.float32)
    a = rng.standard_normal((4, 1, 256), np.float32)
    w = rng.uniform(0.5, 1.5, (256,)).astype(np.float32)
    s, o = add_rms_norm_xla(_t(h), _t(a), _t(w), 1e-6)
    for js, jo in (
            jax_add_rms_norm_xla(jnp.asarray(h), jnp.asarray(a),
                                 jnp.asarray(w), 1e-6),
            jax_fused_add_rms(JaxFusedChainMethod.PALLAS, True,
                              jnp.asarray(h), jnp.asarray(a),
                              jnp.asarray(w), 1e-6, bm=2)):
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-6,
                                   rtol=0)
    for got in (fused_add_rms(_t(h), _t(a), _t(w), 1e-6),
                fused_add_rms_per_device(FusedChainMethod.PALLAS, _t(h),
                                         _t(a), _t(w), 1e-6)):
        assert torch.equal(got[0], s) and torch.equal(got[1], o)


def test_fused_add_rms_bf16_cast_points():
    """bf16: s is h + a rounded to bf16; normed is the f32 normalization
    rounded to bf16, THEN scaled by w (the reference's order)."""
    rng = np.random.default_rng(11)
    h = _t(rng.standard_normal((3, 128), np.float32)).to(torch.bfloat16)
    a = _t(rng.standard_normal((3, 128), np.float32)).to(torch.bfloat16)
    w = _t(rng.uniform(0.5, 1.5, (128,)).astype(np.float32)).to(
        torch.bfloat16)
    s, o = add_rms_norm_xla(h, a, w, 1e-6)
    assert s.dtype == o.dtype == torch.bfloat16
    assert torch.equal(s, (h.float() + a.float()).to(torch.bfloat16))
    sf = s.float()
    want = (sf * torch.rsqrt(sf.pow(2).mean(-1, True) + 1e-6)).to(
        torch.bfloat16) * w
    assert torch.equal(o, want)


def _jax_gemm_ar(method, a, b):
    mesh = make_comm_mesh(axes=[("tp", 1)], devices=jax.devices()[:1])
    fn = td_shard_map(
        lambda a_, b_: jax_gemm_ar_per_device("tp", 1, method, 256, 256,
                                              True, a_, b_),
        mesh=mesh, in_specs=(P(), P()), out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(fn)(a, b))


@needs_interpreter()
@pytest.mark.parametrize("m", [4, 3])
def test_gemm_ar_ref_matches_jax_world1(m):
    """B4's plain version against the JAX gemm_ar at world 1: its XLA
    method and its PALLAS kernel in interpret mode, f32 within 1e-5; the
    wrapper's CPU path and both port methods ARE the plain version."""
    rng = np.random.default_rng(12 + m)
    a = rng.standard_normal((m, 384), np.float32)
    b = rng.standard_normal((384, 256), np.float32) / 16
    got = gemm_ar_ref(_t(a), _t(b))
    for method in (JaxGemmArMethod.XLA, JaxGemmArMethod.PALLAS):
        np.testing.assert_allclose(
            got.numpy(), _jax_gemm_ar(method, jnp.asarray(a),
                                      jnp.asarray(b)), **TOL)
    for out in (gemm_ar(_t(a), _t(b)),
                gemm_ar_per_device(1, GemmArMethod.PALLAS, _t(a), _t(b)),
                gemm_ar_per_device(1, GemmArMethod.XLA, _t(a), _t(b))):
        assert torch.equal(out, got)


def test_gemm_ar_ref_bf16_accumulates_in_f32():
    """bf16 inputs: the exact bf16 products summed in f32, one rounding to
    bf16 at the end (a bf16 running sum would differ); the JAX XLA method
    agrees within one bf16 rounding."""
    rng = np.random.default_rng(14)
    a = _t(rng.standard_normal((4, 512), np.float32)).to(torch.bfloat16)
    b = _t(rng.standard_normal((512, 128), np.float32) / 8).to(
        torch.bfloat16)
    got = gemm_ar_ref(a, b)
    assert got.dtype == torch.bfloat16
    exact = (a.double() @ b.double()).float()
    torch.testing.assert_close(got.float(), exact, rtol=2 ** -8, atol=0)
    want = _jax_gemm_ar(JaxGemmArMethod.XLA,
                        jnp.asarray(a.float().numpy(), jnp.bfloat16),
                        jnp.asarray(b.float().numpy(), jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("m,k,n,vec,want", [
    (4, 4096, 4096, 8, (128, 32)),       # o_proj at decode: 512 blocks
    (4, 12288, 4096, 8, (384, 32)),      # down_proj at decode
    (2048, 4096, 4096, 8, (4096, 1)),    # 4096 tiles already: no split
    (1, 100, 8, 4, (128, 1))])           # K below one 64-row step
def test_gemm_ar_split_plan_covers_k(m, k, n, vec, want):
    """B4's K split on a 132-SM H100: slices of a multiple of 64 rows that
    cover K, about 4 blocks per SM at decode M, no split when the grid is
    already large."""
    k_chunk, splits = split_plan(m, k, n, vec, sm_count=132)
    assert (k_chunk, splits) == want
    assert k_chunk % 64 == 0 and k_chunk * (splits - 1) < k <= \
        k_chunk * splits


def _paged_inputs(seed, b=4, hq=4, hkv=2, d=128, ps=16, num_pages=12,
                  npg=4):
    """Shuffled physical pages, ragged lengths 0 / 1 / a page boundary /
    mid-page, and garbage (out-of-range) entries in dead table slots."""
    rng = np.random.default_rng(seed)
    lengths = np.array([0, 1, 16, 37], np.int32)[:b]
    perm = rng.permutation(num_pages).astype(np.int32)
    table = np.full((b, npg), 99, np.int32)
    table[0] = [-5, 99, 3, 7]                     # a len-0 row: all dead
    used = 0
    for i in range(1, b):
        live = -(-int(lengths[i]) // ps)
        table[i, :live] = perm[used:used + live]
        used += live
    q = rng.standard_normal((b, hq, d), np.float32)
    kp = rng.standard_normal((hkv, num_pages, ps, d), np.float32)
    vp = rng.standard_normal((hkv, num_pages, ps, d), np.float32)
    return q, kp, vp, table, lengths


@needs_interpreter()
def test_paged_decode_ref_matches_jax_f32():
    """B2's plain version vs the JAX kernel: acc, m and l, with an empty
    row (m = NEG_INF, l = 0, acc = 0)."""
    q, kp, vp, table, lengths = _paged_inputs(0)
    acc_j, m_j, l_j = jax_pfd(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(table),
                              jnp.asarray(lengths))
    acc, m, l = paged_flash_decode_partial(_t(q), _t(kp), _t(vp), _t(table),
                                           _t(lengths))
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j), **TOL)
    assert (m[0] == -1e30).all() and (l[0] == 0).all() and (acc[0] == 0).all()
    out = paged_flash_decode(_t(q), _t(kp), _t(vp), _t(table), _t(lengths))
    np.testing.assert_allclose(
        out.numpy(), (acc / l.clamp_min(1e-30)[..., None]).numpy(), **TOL)


@needs_interpreter()
def test_paged_decode_ref_matches_jax_int8():
    """int8-resident mode: pools and row scales written by the port's
    paged_write_layer are byte-identical to the JAX writer's, and the
    plain version of B2 over them matches the JAX kernel."""
    q, _, _, table, lengths = _paged_inputs(1)
    rng = np.random.default_rng(2)
    b, hkv, d, ps, num_pages = 4, 2, 128, 16, 12
    t = 40
    k_new = rng.standard_normal((b, t, hkv, d), np.float32)
    v_new = rng.standard_normal((b, t, hkv, d), np.float32)
    active = np.arange(t)[None, :] < lengths[:, None]          # (B, T)
    start = np.zeros((b,), np.int32)

    cache = PagedKVCache.create(1, b, 64, hkv, d, page_size=ps,
                                num_pages=num_pages, dtype=torch.float32,
                                resident="kv_int8_row")
    lk, lv = cache.k_pages[0], cache.v_pages[0]
    ks, vs = cache.k_scales[0], cache.v_scales[0]
    paged_write_layer(_t(table), _t(start), ps, lk, lv, _t(k_new),
                      _t(v_new), active=_t(active), layer_k_scales=ks,
                      layer_v_scales=vs)

    z8 = jnp.zeros((hkv, num_pages, ps, d), jnp.int8)
    zs = jnp.zeros((hkv, num_pages, ps), jnp.float32)
    jlk, jlv, jks, jvs = jax_paged_write_layer(
        jnp.asarray(table), jnp.asarray(start), ps, z8, z8,
        jnp.asarray(k_new), jnp.asarray(v_new), active=jnp.asarray(active),
        layer_k_scales=zs, layer_v_scales=zs)
    np.testing.assert_array_equal(lk.numpy(), np.asarray(jlk))
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jks))
    np.testing.assert_array_equal(vs.numpy(), np.asarray(jvs))

    acc_j, m_j, l_j = jax_pfd(jnp.asarray(q), jlk, jlv, jnp.asarray(table),
                              jnp.asarray(lengths), k_scales=jks,
                              v_scales=jvs)
    acc, m, l = paged_flash_decode_partial(_t(q), lk, lv, _t(table),
                                           _t(lengths), k_scales=ks,
                                           v_scales=vs)
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), **TOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_j), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(l_j), **TOL)


def test_kv_row_codec_bit_identical_to_jax():
    """Encode gives the JAX codec's exact bytes and scales: zero rows
    (scale 1), exact .5 ties (round half to even), bf16 and f32 inputs."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 3, 128)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1] = 0.0
    x[1, 1, 0], x[1, 1, 1], x[1, 1, 2] = 127.0, 0.5, 2.5   # ties at scale 1
    for xt, xj in ((_t(x), jnp.asarray(x)),
                   (_t(x).to(torch.bfloat16), jnp.asarray(x, jnp.bfloat16))):
        q, s = kv_row_encode(xt)
        qj, sj = jax_kv_row_encode(xj)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(kv_row_decode(q, s).numpy(),
                                      np.asarray(jax_kv_row_decode(qj, sj)))


def test_lse_merge_matches_jax():
    rng = np.random.default_rng(4)
    accs = rng.standard_normal((3, 2, 4, 16), np.float32)
    ms = rng.standard_normal((3, 2, 4), np.float32)
    ls = rng.uniform(0.5, 2.0, (3, 2, 4)).astype(np.float32)
    ms[1, 0, 0] = -1e30                  # an empty partial
    ls[1, 0, 0] = 0.0
    got = lse_partial_merge(_t(accs), _t(ms), _t(ls))
    want = jax_lse_partial_merge(jnp.asarray(accs), jnp.asarray(ms),
                                 jnp.asarray(ls))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    np.testing.assert_allclose(
        lse_merge(_t(accs), _t(ms), _t(ls)).numpy(),
        np.asarray(jax_lse_merge(jnp.asarray(accs), jnp.asarray(ms),
                                 jnp.asarray(ls))), **TOL)


def test_wrappers_reject_unsupported_devices():
    """A non-CPU, non-CUDA tensor never reaches a plain version."""
    q = torch.zeros((1, 4, 2, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill(q, q, q, 0)
    q3 = torch.zeros((1, 2, 128), device="meta")
    pool = torch.zeros((1, 2, 4, 128), device="meta")
    tab = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_flash_decode_partial(q3, pool, pool, tab, tab[:, 0])
    x = torch.zeros((2, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fused_add_rms(x, x, x[0], 1e-6)
    with pytest.raises(ValueError, match="unsupported device"):
        gemm_ar(x, x.T)
