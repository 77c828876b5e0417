"""One rank of the expert-parallel parity tests (tests/test_torch_ep_*.py).

    python tests/torch_ep_worker.py RANK WORLD STORE INPUTS OUTDIR PART

Joins a gloo process group of WORLD ranks through a FileStore at STORE,
runs the cases of PART on the CPU over the inputs in INPUTS (an .npz the
test writes) and writes this rank's results to OUTDIR/rank<RANK>.npz and
its checks to OUTDIR/rank<RANK>.json. PART "ops": dispatch and combine
under XLA and PALLAS at two capacities, B16's plain version
(``dispatch_gg``) at comm_blocks 1 and 4, the fp8 transport and the
policy's refusals; "model": the EP parameter shards and
``tiny_qwen3_moe(moe_parallel="ep")`` logits in xla and in triton_dist
under each transport; "engine": the greedy tokens of ``Engine`` in
triton_dist under each transport and at its defaults (the mega step's
xla tier) and on the fused tier (pallas_chain: the default transport and
PALLAS_FUSED); "cont2" (two ranks): a ContinuousEngine serve of the EP
model. Imports torch and the port, never JAX.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_ep_cases import (  # noqa: E402
    E, EP_GEN, EP_LAYERS, EP_MAX_LEN, M_LOC, MAX_M, METHODS, SMALL_M, TOPK,
)
from torch_world import finish  # noqa: E402
from triton_dist_tpu_torch.kernels.ep_a2a import (  # noqa: E402
    EpA2AMethod, combine, create_ep_a2a_context, dispatch, dispatch_gg,
)
from triton_dist_tpu_torch.kernels.low_latency_all_to_all import (  # noqa: E402,E501
    fast_all_to_all_quantized,
)
from triton_dist_tpu_torch.kernels import launch_counts  # noqa: E402
from triton_dist_tpu_torch.layers import TPContext  # noqa: E402
from triton_dist_tpu_torch.mega.runtime import (  # noqa: E402
    MegaDecodeRuntime,
)
from triton_dist_tpu_torch.models import (  # noqa: E402
    ContinuousEngine, Engine, Qwen3MoE, params_from_numpy, tiny_qwen3_moe,
)
from triton_dist_tpu_torch.runtime import mesh as tp_mesh  # noqa: E402

TD_METHODS = ("xla", "pallas", "pallas_fused")


def ep_arch(world: int, num_experts: int = E, topk: int = TOPK,
            num_layers: int = EP_LAYERS):
    return dataclasses.replace(
        tiny_qwen3_moe(num_layers=num_layers, tp=world,
                       num_experts=num_experts, topk=topk),
        moe_parallel="ep")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _unflatten(flat: dict, prefix: str) -> dict:
    out = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def _raises(fn, exc, match: str) -> bool:
    try:
        fn()
    except exc as e:
        return match in str(e)
    return False


def _disp_out(out: dict, key: str, d) -> None:
    out[f"{key}/x"] = d.x.numpy()
    out[f"{key}/ids"] = d.expert_ids.numpy()
    out[f"{key}/counts"] = d.counts.numpy()
    out[f"{key}/overflow"] = d.overflow.numpy()
    out[f"{key}/dest"] = d.layout.dest.numpy()
    out[f"{key}/pos"] = d.layout.pos.numpy()
    out[f"{key}/send_counts"] = d.layout.send_counts.numpy()


def _ops(inp, mesh, out: dict, checks: dict) -> None:
    r, n = mesh.rank, mesh.world
    rows = slice(r * M_LOC, (r + 1) * M_LOC)
    tok, ids = _t(inp["tok"][rows]), _t(inp["ids"][rows])
    tok_int, tw = _t(inp["tok_int"][rows]), _t(inp["topk_w"][rows])
    for method in METHODS:
        for mm in (MAX_M, SMALL_M):
            ctx = create_ep_a2a_context(mesh, E, TOPK, mm,
                                        method=EpA2AMethod(method))
            d = dispatch(ctx, tok_int, ids)
            _disp_out(out, f"disp/{method}/m{mm}", d)
            eo = _t(inp[f"expert_out_m{mm}"][r * n:(r + 1) * n])
            out[f"comb/{method}/m{mm}"] = combine(ctx, eo, d, tw).numpy()
    # B16's plain version (PALLAS_FUSED on CPU tensors)
    e_loc = E // n
    w_loc = _t(inp["w_gate_up_int"][r * e_loc:(r + 1) * e_loc])
    for cb in (1, 4):
        ctx = create_ep_a2a_context(mesh, E, TOPK, MAX_M,
                                    method=EpA2AMethod.PALLAS_FUSED, bm=8,
                                    comm_blocks=cb)
        d, inter = dispatch_gg(ctx, tok_int, ids, w_loc)
        _disp_out(out, f"gg/cb{cb}", d)
        out[f"gg/cb{cb}/inter"] = inter.numpy()
    # the fp8 transport: the mesh-level op, and dispatch with an explicit
    # payload dtype and through TD_QUANT=always
    qs = _t(inp["q_slots"][r * n:(r + 1) * n])
    out["fp8/a2a_q"] = fast_all_to_all_quantized(mesh, "tp", qs).numpy()
    for method in METHODS:
        ctx = create_ep_a2a_context(mesh, E, TOPK, MAX_M,
                                    method=EpA2AMethod(method),
                                    payload_dtype=torch.float8_e4m3fn)
        out[f"fp8/disp/{method}"] = dispatch(ctx, tok, ids).x.numpy()
    ctx = create_ep_a2a_context(mesh, E, TOPK, MAX_M,
                                method=EpA2AMethod.PALLAS)
    os.environ["TD_QUANT"] = "always"
    try:
        out["fp8/policy_always"] = dispatch(ctx, tok, ids).x.numpy()
        os.environ["TD_QUANT"] = "error_budget:0.5"
        checks["error_budget_raises_a13"] = _raises(
            lambda: dispatch(ctx, tok, ids), NotImplementedError,
            "ROADMAP A13")
    finally:
        del os.environ["TD_QUANT"]
    checks["dcn_axis_raises_a9"] = _raises(
        lambda: create_ep_a2a_context(mesh, E, TOPK, MAX_M, dcn_axis="dcn"),
        NotImplementedError, "ROADMAP A9 (tail)")
    checks["odd_experts_raise"] = _raises(
        lambda: create_ep_a2a_context(mesh, E + 1, TOPK, MAX_M),
        ValueError, "not divisible")
    checks["no_launch_on_cpu"] = not any(launch_counts().values())


def _ep_ctx(mesh, method: str, **kw) -> TPContext:
    return TPContext(mesh, ep_a2a_method=EpA2AMethod(method), **kw)


def _model(inp, mesh, out: dict, checks: dict) -> None:
    r, n = mesh.rank, mesh.world
    arch = ep_arch(n)
    params = params_from_numpy(
        _unflatten({k: inp[k] for k in inp.files}, "param/"), arch, "cpu",
        torch.float32, rank=r, world=n)
    for k, v in params.items():
        if k != "layers":
            out[f"shard/{k}"] = v.numpy()
    for k, v in params["layers"].items():
        out[f"shard/layers/{k}"] = v.numpy()
    ids = _t(inp["ids_model"]).long()
    rows = slice(r * (ids.shape[0] // n), (r + 1) * (ids.shape[0] // n))
    for method in TD_METHODS:
        model = Qwen3MoE(arch, _ep_ctx(mesh, method), max_length=EP_MAX_LEN,
                         dtype=torch.float32, device="cpu")
        lt, _ = model.inference(params, model.create_kv_cache(ids.shape[0]),
                                ids[rows], mode="triton_dist")
        out[f"logits/triton_dist/{method}"] = lt.numpy()
    lx, _ = model.inference(params, model.create_kv_cache(ids.shape[0]),
                            ids, mode="xla")
    out["logits/xla"] = lx.numpy()
    # ep_max_m below the worst case: the layer warns of the dropped pairs
    small = Qwen3MoE(arch, _ep_ctx(mesh, "xla", ep_max_m=1),
                     max_length=EP_MAX_LEN, dtype=torch.float32,
                     device="cpu")
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        small.inference(params, small.create_kv_cache(ids.shape[0]),
                        ids[rows], mode="triton_dist")
    checks["small_max_m_warns"] = any(
        "raise TPContext.ep_max_m" in str(w.message) for w in caught)


def _engine(inp, mesh, out: dict, checks: dict) -> None:
    r, n = mesh.rank, mesh.world
    arch = ep_arch(n)
    params = params_from_numpy(
        _unflatten({k: inp[k] for k in inp.files}, "param/"), arch, "cpu",
        torch.float32, rank=r, world=n)
    prompt = _t(inp["prompt"]).long()

    def model_of(method="xla"):
        return Qwen3MoE(arch, _ep_ctx(mesh, method), max_length=EP_MAX_LEN,
                        dtype=torch.float32, device="cpu")

    for method in TD_METHODS:
        out[f"tokens/triton_dist/{method}"] = Engine(
            model_of(method), params, backend="triton_dist").serve(
                prompt, EP_GEN).numpy()
    eng = Engine(model_of(), params)
    out["tokens/mega_default"] = eng.serve(prompt, EP_GEN).numpy()
    checks["mega_default_tier"] = eng.mega_tier
    out["differs/mega_default"] = eng.own_token_differs.numpy()
    eng = Engine(model_of(), params, mega="pallas_chain")
    out["tokens/mega_fused"] = eng.serve(prompt, EP_GEN).numpy()
    graph = eng._mega_rt.dense_builder().graph
    checks["moe_fused_tiers"] = sum(
        t.task_type == "moe" and "pallas_chain" in (t.tier_fns or {})
        for t in graph.tasks)
    model = model_of()
    eng = Engine(model, params, mega="pallas_chain")
    eng._mega_rt = MegaDecodeRuntime(model, method="pallas_chain",
                                     ep_a2a_method=EpA2AMethod.PALLAS_FUSED)
    out["tokens/mega_fused_b16"] = eng.serve(prompt, EP_GEN).numpy()


def _cont2(inp, mesh, out: dict, checks: dict) -> None:
    r, n = mesh.rank, mesh.world
    arch = ep_arch(n, num_experts=4, topk=2)
    params = params_from_numpy(
        _unflatten({k: inp[k] for k in inp.files}, "cparam/"), arch, "cpu",
        torch.float32, rank=r, world=n)
    model = Qwen3MoE(arch, TPContext(mesh), max_length=64,
                     dtype=torch.float32, device="cpu")
    eng = ContinuousEngine(model, params, max_batch=2, temperature=0.0,
                           page_size=8)
    eng.submit([3, 1, 4, 1], max_new_tokens=4)
    eng.submit([2, 7], max_new_tokens=3)
    done = eng.run()
    checks["outs"] = [list(map(int, d.out)) for d in done]
    checks["mega"] = eng.stats()["mega"]
    checks["own_token_differs"] = eng.own_token_differs


PARTS = {"ops": _ops, "model": _model, "engine": _engine, "cont2": _cont2}


def main(rank: str, world: str, store: str, inputs: str, outdir: str,
         part: str):
    rank, world = int(rank), int(world)
    torch.manual_seed(0)
    checks: dict = {}
    out: dict = {}
    try:
        tp_mesh.initialize_distributed(f"file://{store}", world, rank,
                                       device="cpu")
        mesh = tp_mesh.make_comm_mesh()
        PARTS[part](np.load(inputs), mesh, out, checks)
        dist.barrier()
        checks["error"] = None
    except BaseException:
        checks["error"] = traceback.format_exc()
    finish(rank, outdir, out, checks)


if __name__ == "__main__":
    main(*sys.argv[1:])
