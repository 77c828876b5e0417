"""The port's paged serving slice as a whole against the JAX Engine.

Both sides get the same numpy weights (the JAX side through put_params,
the port through params_from_numpy) and the same prompt, in f32. The JAX
prefill runs its flash kernel (head_dim 128, T = 128) in interpret mode
and its decode the paged kernel. Greedy tokens must be IDENTICAL and the
prefill logits agree within 1e-4 (f32 through two layers and the vocab
projection, summation orders differing between the libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import needs_interpreter
from triton_dist_tpu.layers import TPContext as JaxTPContext
from triton_dist_tpu.models.config import Qwen3Arch as JaxQwen3Arch
from triton_dist_tpu.models.engine import Engine as JaxEngine
from triton_dist_tpu.models.qwen import Qwen3 as JaxQwen3
from triton_dist_tpu.models.weights import put_params
from triton_dist_tpu.runtime import make_comm_mesh

from triton_dist_tpu_torch.models import (
    AutoLLM, Engine, ModelConfig, Qwen3, Qwen3Arch, init_random_params,
    params_from_numpy, sample_token, tiny_qwen3,
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
    logits, _ = model.inference(params, cache, jnp.asarray(ids))
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


def test_cpu_gate_and_unported_options_raise():
    """No card: the default device raises at construction; device="cpu"
    runs. Unported options name their ROADMAP item."""
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
    out = Engine(model, params, page_size=8).serve(
        torch.zeros((2, 5), dtype=torch.int64), gen_len=4)
    assert out.shape == (2, 4) and out.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        Engine(model, params, cache_mode="dense")
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        Engine(model, params, spec="auto")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        Engine(model, params, backend="triton_dist")
    with pytest.raises(NotImplementedError, match="ROADMAP A3"):
        model.create_kv_cache(2)


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
