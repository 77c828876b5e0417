"""The port's serving slices as a whole against the JAX Engine: the
default dense cache with its mega decode step, and the paged cache.

Both sides get the same numpy weights (the JAX side through put_params,
the port through params_from_numpy) and the same prompt, in f32. The JAX
prefill runs its flash kernel (head_dim 128, T = 128) in interpret mode
and its decode the dense mega program or the paged kernel. Greedy tokens
must be IDENTICAL and the prefill logits agree within 1e-4 (f32 through
two layers and the vocab projection, summation orders differing between
the libraries).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import needs_interpreter
from triton_dist_tpu.layers import TPContext as JaxTPContext
from triton_dist_tpu.models.config import Qwen3Arch as JaxQwen3Arch
from triton_dist_tpu.models.engine import Engine as JaxEngine
from triton_dist_tpu.models.kv_cache import KVCache as JaxKVCache
from triton_dist_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_dist_tpu.models.weights import put_params
from triton_dist_tpu.runtime import make_comm_mesh

from triton_dist_tpu_torch.models import (
    AutoLLM, Engine, KVCache, ModelConfig, Qwen3, Qwen3Arch,
    init_random_params, params_from_numpy, sample_token, tiny_qwen3,
)
from triton_dist_tpu_torch.models.weights import param_shapes

ARCH_128 = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128)
TINY = dict(vars(tiny_qwen3(tp=1)))
MAX_LEN = 160
B, T, GEN = 2, 128, 8


def _raw_params(arch, seed):
    """numpy weights in the reference's layout: matrices ~ N(0, 1/d),
    norm weights near 1 (so a wrong norm order shows)."""
    rng = np.random.default_rng(seed)

    def make(name, shape):
        if "norm" in name:
            return rng.uniform(0.8, 1.2, shape).astype(np.float32)
        return (rng.standard_normal(shape, np.float32)
                * arch.hidden_size ** -0.5)

    shapes = param_shapes(arch)
    raw = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    raw["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    return raw


def _jax_serve(arch_kw, raw, ids, kv_resident):
    mesh = make_comm_mesh(axes=[("tp", 1)], devices=jax.devices()[:1])
    ctx = JaxTPContext(mesh, "tp")
    arch = JaxQwen3Arch(**arch_kw)
    model = JaxQwen3(arch, ctx, max_length=MAX_LEN, dtype=jnp.float32)
    params = put_params(raw, arch, ctx)
    eng = JaxEngine(model, params, cache_mode="paged", page_size=32,
                    kv_resident=kv_resident)
    toks = np.asarray(eng.serve(jnp.asarray(ids), gen_len=GEN))
    cache = model.create_paged_kv_cache(B, page_size=32,
                                        kv_resident=kv_resident)
    logits, _ = jax.jit(model.inference)(params, cache, jnp.asarray(ids))
    return toks, np.asarray(logits), eng.kv_cache


@needs_interpreter()
@pytest.mark.parametrize("arch_kw,kv_resident", [
    (ARCH_128, None), (ARCH_128, "int8"), (TINY, None)],
    ids=["hd128_flash", "hd128_int8", "tiny_einsum"])
def test_engine_serve_matches_jax(arch_kw, kv_resident):
    arch = Qwen3Arch(**arch_kw)
    raw = _raw_params(arch, seed=7)
    ids = np.random.default_rng(8).integers(0, arch.vocab_size, (B, T),
                                            dtype=np.int32)
    want_toks, want_logits, jcache = _jax_serve(arch_kw, raw, ids,
                                                kv_resident)

    model = Qwen3(arch, max_length=MAX_LEN, dtype=torch.float32,
                  device="cpu")
    params = params_from_numpy(raw, arch, "cpu", torch.float32)
    eng = Engine(model, params, cache_mode="paged", page_size=32,
                 kv_resident=kv_resident)
    toks = eng.serve(torch.from_numpy(ids), gen_len=GEN)
    cache = model.create_paged_kv_cache(B, page_size=32,
                                        kv_resident=kv_resident)
    logits, _ = model.inference(params, cache, torch.from_numpy(ids))

    assert toks.dtype == torch.int32 and toks.shape == (B, GEN)
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=1e-4,
                               rtol=1e-4)
    for name in ("block_table", "lengths", "free_stack", "next_free",
                 "overflow", "ref_count"):
        np.testing.assert_array_equal(getattr(eng.kv_cache, name).numpy(),
                                      np.asarray(getattr(jcache, name)),
                                      err_msg=name)
    assert eng.kv_cache.resident_codec == jcache.resident_codec


@functools.lru_cache(maxsize=None)
def _jax_dense_tokens(arch_name):
    """The JAX Engine at its defaults (dense cache, mega "auto": the xla
    tier off a TPU) on the test prompt; one run per architecture."""
    arch_kw = {"hd128_flash": ARCH_128, "tiny_einsum": TINY}[arch_name]
    arch = Qwen3Arch(**arch_kw)
    raw = _raw_params(arch, seed=7)
    ids = np.random.default_rng(8).integers(0, arch.vocab_size, (B, T),
                                            dtype=np.int32)
    mesh = make_comm_mesh(axes=[("tp", 1)], devices=jax.devices()[:1])
    ctx = JaxTPContext(mesh, "tp")
    jarch = JaxQwen3Arch(**arch_kw)
    model = JaxQwen3(jarch, ctx, max_length=MAX_LEN, dtype=jnp.float32)
    eng = JaxEngine(model, put_params(raw, jarch, ctx))
    assert eng.cache_mode == "dense" and eng._mega_rt is not None
    toks = np.asarray(eng.serve(jnp.asarray(ids), gen_len=GEN))
    return raw, ids, toks, int(eng.kv_cache.offset)


@needs_interpreter()
@pytest.mark.parametrize("mega", ["off", "xla", "pallas_chain"])
@pytest.mark.parametrize("arch_name", ["hd128_flash", "tiny_einsum"])
def test_dense_engine_matches_jax(arch_name, mega):
    """The default dense Engine: greedy tokens IDENTICAL to the JAX dense
    Engine with the decode step layer by layer (mega "off"), on the mega
    xla tier, and on the pallas_chain tier (B3's and B4's plain versions
    on CPU tensors); one dispatch per decode step on the mega path."""
    raw, ids, want, want_offset = _jax_dense_tokens(arch_name)
    arch = Qwen3Arch(**{"hd128_flash": ARCH_128, "tiny_einsum": TINY}[
        arch_name])
    model = Qwen3(arch, max_length=MAX_LEN, dtype=torch.float32,
                  device="cpu")
    params = params_from_numpy(raw, arch, "cpu", torch.float32)
    eng = Engine(model, params, mega=mega)
    toks = eng.serve(torch.from_numpy(ids), gen_len=GEN)
    assert toks.dtype == torch.int32 and toks.shape == (B, GEN)
    np.testing.assert_array_equal(toks.numpy(), want)
    assert isinstance(eng.kv_cache, KVCache)
    assert int(eng.kv_cache.offset) == want_offset == T + GEN - 1
    assert eng.mega_tier == (None if mega == "off" else mega)
    if mega != "off":
        assert eng._mega_rt.launches == GEN - 1
    assert eng.graph_replays == 0          # no CUDA graph on the CPU


def test_default_engine_builds_dense_cache_and_reuses_it():
    """Engine() with no cache_mode serves on a dense KVCache (the
    reference's default) with the mega tier AUTO resolves to on the CPU;
    a second serve of the same batch reuses the cache, another batch size
    makes a new one."""
    arch = Qwen3Arch(**TINY)
    model = Qwen3(arch, max_length=32, dtype=torch.float32, device="cpu")
    params = init_random_params(torch.Generator().manual_seed(2), arch,
                                "cpu", torch.float32)
    eng = Engine(model, params)
    assert eng.cache_mode == "dense" and eng.mega_tier == "xla"
    ids = torch.ones((2, 6), dtype=torch.int64)
    first = eng.serve(ids, gen_len=4)
    cache = eng.kv_cache
    assert isinstance(cache, KVCache) and cache.k.shape == (
        arch.num_layers, 2, 32, arch.num_kv_heads, arch.head_dim)
    assert cache.offset.shape == () and cache.offset.dtype == torch.int32
    assert int(cache.offset) == 6 + 4 - 1
    assert torch.equal(eng.serve(ids, gen_len=4), first)
    assert eng.kv_cache is cache
    eng.serve(ids[:1], gen_len=2)
    assert eng.kv_cache is not cache and eng.kv_cache.batch == 1
    with pytest.raises(ValueError, match="exceeds"):
        eng.serve(ids, gen_len=28)
    with pytest.raises(ValueError, match="paged cache"):
        model.inference(params, cache, ids[:, :1],
                        active=torch.ones(2, dtype=torch.bool))


def test_kv_cache_create_clear_rewind_match_jax():
    """KVCache: the reference's slab layout, dtype and offset; clear and
    rewind move only the offset (in place here, functionally there)."""
    ours = KVCache.create(3, 2, 16, 4, 32, dtype=torch.float32)
    ref = JaxKVCache.create(3, 2, 16, 4, 32, dtype=jnp.float32)
    assert tuple(ours.k.shape) == ref.k.shape == ref.v.shape
    assert ours.v.shape == ours.k.shape and ours.k.dtype == torch.float32
    assert ours.max_length == ref.max_length == 16 and ours.batch == 2
    assert ours.offset.dtype == torch.int32 and ours.offset.ndim == 0
    assert int(ours.offset) == int(ref.offset) == 0
    ours.k.fill_(1.0)
    for _ in range(2):
        ours.advance(5)
        ref = dataclasses.replace(ref, offset=ref.offset + 5)
    assert ours.rewind(3) is ours
    ref = ref.rewind(3)
    assert int(ours.offset) == int(ref.offset) == 7
    assert ours.rewind(torch.tensor(2)) is ours
    assert int(ours.offset) == int(ref.rewind(2).offset) == 5
    assert ours.clear() is ours
    assert int(ours.offset) == int(ref.clear().offset) == 0
    assert bool((ours.k == 1.0).all())          # slabs untouched


def test_cpu_gate_and_unported_options_raise():
    """No card: the default device raises at construction; device="cpu"
    runs. Unported options name their ROADMAP item; triton_dist_AR at
    world 1 serves the xla decode's tokens."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    arch = Qwen3Arch(**TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Qwen3(arch, max_length=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AutoLLM.from_pretrained("Qwen/Qwen3-8B")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_random_params(torch.Generator(), arch)
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        AutoLLM.from_pretrained(ModelConfig("Qwen/Qwen3-8B"),
                                checkpoint_dir="/nonexistent")
    with pytest.raises(ValueError, match="unknown model"):
        AutoLLM.from_pretrained("Qwen/Qwen3-7B", device="cpu")

    model = Qwen3(arch, max_length=32, dtype=torch.float32, device="cpu")
    params = init_random_params(torch.Generator().manual_seed(0), arch,
                                "cpu", torch.float32)
    for mode in ("paged", "dense"):
        out = Engine(model, params, cache_mode=mode, page_size=8).serve(
            torch.zeros((2, 5), dtype=torch.int64), gen_len=4)
        assert out.shape == (2, 4) and out.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown cache_mode"):
        Engine(model, params, cache_mode="ring")
    with pytest.raises(ValueError, match="mega="):
        Engine(model, params, mega="fused")
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        Engine(model, params, spec="auto")
    # triton_dist_AR at world 1: its sums are the identity, so its
    # captured-step decode serves the xla decode's tokens
    prompt = torch.arange(10, dtype=torch.int64).reshape(2, 5)
    assert torch.equal(
        Engine(model, params, backend="triton_dist_AR").serve(prompt, 4),
        Engine(model, params, mega="off").serve(prompt, 4))
    with pytest.raises(RuntimeError, match="no KV cache"):
        Engine(model, params).step(torch.zeros(2, dtype=torch.int32))


def test_prefill_into_nonempty_cache_raises_and_decode_grows():
    arch = Qwen3Arch(**TINY)
    model = Qwen3(arch, max_length=32, dtype=torch.float32, device="cpu")
    params = init_random_params(torch.Generator().manual_seed(1), arch,
                                "cpu", torch.float32)
    cache = model.create_paged_kv_cache(2, page_size=8)
    ids = torch.ones((2, 6), dtype=torch.int64)
    logits, cache = model.inference(params, cache, ids)
    assert logits.dtype == torch.float32 and logits.shape == (2, 256)
    with pytest.raises(ValueError, match="requires an empty cache"):
        model.inference(params, cache, ids)
    with pytest.raises(ValueError, match="decode-only"):
        model.inference(params, cache, ids,
                        active=torch.ones(2, dtype=torch.bool))
    # frozen row: neither grows nor writes
    _, cache = model.inference(params, cache, ids[:, :1],
                               active=torch.tensor([True, False]))
    assert cache.lengths.tolist() == [7, 6]


def test_params_from_numpy_and_random_init():
    arch = Qwen3Arch(**TINY)
    raw = _raw_params(arch, seed=1)
    params = params_from_numpy(raw, arch, "cpu", torch.bfloat16)
    assert params["layers"]["wqkv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  torch.from_numpy(raw["embed"]).to(
                                      torch.bfloat16).float().numpy())
    bf = jnp.asarray(raw["lm_head"], jnp.bfloat16)      # ml_dtypes bfloat16
    raw_bf = dict(raw, lm_head=np.asarray(bf))
    got = params_from_numpy(raw_bf, arch, "cpu", torch.bfloat16)
    assert torch.equal(got["lm_head"], params["lm_head"])
    bad = dict(raw, embed=raw["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(bad, arch, "cpu")
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy({k: v for k, v in raw.items() if k != "lm_head"},
                          arch, "cpu")

    a = init_random_params(torch.Generator().manual_seed(3), arch, "cpu")
    b = init_random_params(torch.Generator().manual_seed(3), arch, "cpu")
    for k, s in param_shapes(arch)["layers"].items():
        assert tuple(a["layers"][k].shape) == s
        assert a["layers"][k].dtype == torch.bfloat16
        assert torch.equal(a["layers"][k], b["layers"][k])
    assert torch.equal(a["final_norm"], torch.ones_like(a["final_norm"]))


def test_sample_token_greedy_ties_and_sampled_top_p():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert sample_token(logits).tolist() == [1, 0]       # first-index ties
    assert sample_token(logits).tolist() == \
        np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), -1)).tolist()
    g = torch.Generator().manual_seed(0)
    big = torch.tensor([[10.0, 9.5, -5.0, -5.0]]).repeat(64, 1)
    draws = sample_token(big, g, temperature=1.0, top_p=0.5)
    assert set(draws.tolist()) == {0}                    # top-p keeps one
    draws = sample_token(big, g, temperature=1.0, top_p=1.0)
    assert set(draws.tolist()) <= {0, 1, 2, 3} and len(set(draws.tolist())) > 1
