"""One rank of the MoE tensor-parallel parity tests
(tests/test_torch_moe_tp*.py).

    python tests/torch_moe_tp_worker.py RANK WORLD STORE INPUTS OUTDIR PART

Joins a gloo process group of WORLD ranks through a FileStore at STORE,
runs the cases of PART on the CPU over the inputs in INPUTS (an .npz the
test writes) and writes this rank's results to OUTDIR/rank<RANK>.npz and
its checks to OUTDIR/rank<RANK>.json. PART "ops": B14
(``ag_group_gemm_per_device``) and B15 (``moe_reduce_rs_per_device``) in
every tier at comm_blocks 1 and 4; "model": the parameter shards,
``moe_fwd`` in the three modes, ``tiny_qwen3_moe(tp=n)`` logits and the
Engine's greedy tokens, the ContinuousEngine's run of the continuous TP
tests' script (tests/torch_continuous_worker.py), and the refusals that
remain. Imports torch and
the port, never JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from triton_dist_tpu_torch.kernels.allgather_gemm import (  # noqa: E402
    AgGemmMethod,
)
from triton_dist_tpu_torch.kernels.allgather_group_gemm import (  # noqa: E402
    AgGroupGemmMethod, ag_group_gemm_per_device,
)
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (  # noqa: E402
    GemmRsMethod,
)
from triton_dist_tpu_torch.kernels.moe_reduce_rs import (  # noqa: E402
    MoeReduceRsMethod, moe_reduce_rs_per_device,
)
from triton_dist_tpu_torch.layers import TPContext  # noqa: E402
from triton_dist_tpu_torch.layers.tp_moe import moe_fwd  # noqa: E402
from triton_dist_tpu_torch.mega.models.qwen3 import (  # noqa: E402
    build_qwen3_decode,
)
from triton_dist_tpu_torch.models import (  # noqa: E402
    QWEN3_ARCHS, AutoLLM, ContinuousEngine, Engine, Qwen3MoE,
    init_random_params, params_from_numpy, tiny_qwen3_moe,
)
from triton_dist_tpu_torch.runtime import mesh as tp_mesh  # noqa: E402
from torch_continuous_worker import (  # noqa: E402
    ENGINE_KW, LAYERS as CONT_LAYERS, MAX_LEN as CONT_MAX_LEN, run_script,
)

TIERS = ("xla", "xla_ring", "pallas")
COMM_BLOCKS = (1, 4)
BM = 8                                  # as the JAX side's contexts
LAYERS, MAX_LEN, GEN = 2, 32, 4


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


def _ops(inp, mesh, out: dict) -> None:
    """B14 on this rank's token rows and weight columns, B15 on its
    intermediate columns and weight rows, every tier; the plain versions
    (PALLAS on CPU tensors) at each comm_blocks."""
    r, n = mesh.rank, mesh.world
    e = int(inp["num_experts"])
    for kind in ("int", "rand"):
        tok, ids = _t(inp[f"b14_tok_{kind}"]), _t(inp["ids"])
        w = _t(inp[f"b14_w_{kind}"])
        m, nl = tok.shape[0] // n, w.shape[-1] // n
        tok_loc = tok[r * m:(r + 1) * m]
        w_loc = w[..., r * nl:(r + 1) * nl].contiguous()
        inter, wd = _t(inp[f"b15_inter_{kind}"]), _t(inp[f"b15_w_{kind}"])
        tw = _t(inp[f"topk_w_{kind}"])
        il = inter.shape[1] // n
        inter_loc = inter[:, r * il:(r + 1) * il].contiguous()
        wd_loc = wd[:, r * il:(r + 1) * il].contiguous()
        for tier in TIERS:
            for cb in COMM_BLOCKS if tier == "pallas" else (4,):
                key = f"{kind}/{tier}/cb{cb}"
                o, ag = ag_group_gemm_per_device(
                    n, e, AgGroupGemmMethod(tier), tok_loc, ids, w_loc,
                    bm=BM, comm_blocks=cb, mesh=mesh)
                out[f"b14/{key}/out"], out[f"b14/{key}/ag"] = \
                    o.numpy(), ag.numpy()
                out[f"b15/{key}"] = moe_reduce_rs_per_device(
                    n, e, ids.shape[1], MoeReduceRsMethod(tier), inter_loc,
                    ids, tw, wd_loc, bm=BM, comm_blocks=cb,
                    mesh=mesh).numpy()


def _moe_weights(inp, r: int, n: int) -> dict:
    """This rank's shards of the moe_fwd case's global weights."""
    wgu, wd = inp["fwd_w_gate_up"], inp["fwd_w_down"]
    c, il = wgu.shape[-1] // n, wd.shape[1] // n
    return {"w_router": _t(inp["fwd_w_router"]),
            "w_gate_up": _t(wgu[..., r * c:(r + 1) * c]),
            "w_down": _t(wd[:, r * il:(r + 1) * il])}


def _ctx(mesh, tier: str) -> TPContext:
    """Every method of the triton_dist mode on one tier."""
    return TPContext(mesh, ag_method=AgGemmMethod(tier),
                     rs_method=GemmRsMethod(tier),
                     moe_ag_method=AgGroupGemmMethod(tier),
                     moe_rs_method=MoeReduceRsMethod(tier))


def _model(inp, mesh, out: dict, checks: dict) -> None:
    r, n = mesh.rank, mesh.world
    arch = tiny_qwen3_moe(num_layers=LAYERS, tp=n)
    raw = _unflatten({k: inp[k] for k in inp.files}, "param/")
    params = params_from_numpy(raw, arch, "cpu", torch.float32, rank=r,
                               world=n)
    for k, v in params.items():
        if k != "layers":
            out[f"shard/{k}"] = v.numpy()
    for k, v in params["layers"].items():
        out[f"shard/layers/{k}"] = v.numpy()
    # moe_fwd alone, each mode (triton_dist on this rank's rows)
    w = _moe_weights(inp, r, n)
    x = _t(inp["fwd_x"])
    b_loc = x.shape[0] // n
    for tier in ("xla_ring", "pallas"):
        ctx = _ctx(mesh, tier)
        for mode in ("xla", "triton_dist_AR"):
            out[f"fwd/{tier}/{mode}"] = moe_fwd(
                mode, ctx, arch.num_experts, arch.num_experts_per_tok,
                arch.norm_topk_prob, w, x).numpy()
        out[f"fwd/{tier}/triton_dist"] = moe_fwd(
            "triton_dist", ctx, arch.num_experts, arch.num_experts_per_tok,
            arch.norm_topk_prob, w, x[r * b_loc:(r + 1) * b_loc]).numpy()
    ids = _t(inp["ids_model"]).long()
    prompt = _t(inp["prompt"]).long()
    rows = slice(r * (ids.shape[0] // n), (r + 1) * (ids.shape[0] // n))
    for tier in ("xla_ring", "pallas"):
        model = Qwen3MoE(arch, _ctx(mesh, tier), max_length=MAX_LEN,
                         dtype=torch.float32, device="cpu")
        lx, _ = model.inference(params, model.create_kv_cache(ids.shape[0]),
                                ids, mode="xla")
        lt, _ = model.inference(params, model.create_kv_cache(ids.shape[0]),
                                ids[rows], mode="triton_dist")
        out[f"logits/{tier}/xla"] = lx.numpy()
        out[f"logits/{tier}/triton_dist"] = lt.numpy()
        out[f"tokens/{tier}/triton_dist"] = Engine(
            model, params, backend="triton_dist").serve(prompt, GEN).numpy()
    model = Qwen3MoE(arch, TPContext(mesh), max_length=MAX_LEN,
                     dtype=torch.float32, device="cpu")
    mega = Engine(model, params)
    out["tokens/mega_default"] = mega.serve(prompt, GEN).numpy()
    out["differs/mega_default"] = mega.own_token_differs.numpy()
    checks["mega_tier"] = mega.mega_tier
    checks["mega_moe_tasks_at_world_n"] = sum(
        t.task_type == "moe"
        for t in build_qwen3_decode(arch, n, mesh=mesh).graph.tasks)
    # the ContinuousEngine on the MoE model at world n, mode xla (its
    # paged mega graph: the moe task with the f32 all-reduce), driven
    # through the continuous TP tests' script
    c_arch = tiny_qwen3_moe(num_layers=CONT_LAYERS, tp=n)
    c_params = params_from_numpy(_unflatten({k: inp[k] for k in inp.files},
                                            "cparam/"), c_arch, "cpu",
                                 torch.float32, rank=r, world=n)
    eng = ContinuousEngine(
        Qwen3MoE(c_arch, TPContext(mesh), max_length=CONT_MAX_LEN,
                 dtype=torch.float32, device="cpu"), c_params, mode="xla",
        **ENGINE_KW)
    trace, done = run_script(eng)
    checks["continuous"] = {"trace": trace, "done": done,
                            "mega": eng.stats()["mega"],
                            "own_token_differs": eng.own_token_differs}
    # what stays refused
    big = torch.zeros((n * 1025, 1), dtype=torch.int32)
    checks["b15_pallas_over_1024_raises"] = _raises(
        lambda: moe_reduce_rs_per_device(
            n, 4, 1, MoeReduceRsMethod.PALLAS, torch.ones((n * 1025, 8)),
            big, torch.ones((n * 1025, 1)), torch.ones((4, 8, 8)),
            mesh=mesh), ValueError, "1024 tokens")
    checks["no_mesh_raises"] = _raises(
        lambda: ag_group_gemm_per_device(
            n, 4, AgGroupGemmMethod.XLA, torch.ones((2, 8)),
            torch.zeros((2 * n, 1), dtype=torch.int32),
            torch.ones((4, 8, 8))), ValueError, "needs the mesh")
    checks["odd_batch_raises"] = _raises(
        lambda: Engine(model, params, backend="triton_dist").serve(
            torch.zeros((n + 1, 4), dtype=torch.long), 2),
        ValueError, "not divisible")
    # AutoLLM builds a Qwen3MoE on the rank's mesh with its shard of the
    # seed-0 world-1 weights
    QWEN3_ARCHS["tiny/moe_tp"] = arch
    auto_model, auto = AutoLLM.from_pretrained("tiny/moe_tp",
                                               TPContext(mesh))
    seed0 = init_random_params(torch.Generator().manual_seed(0), arch,
                               "cpu", torch.bfloat16, rank=r, world=n)
    checks["autollm_moe_rank_shard"] = isinstance(auto_model, Qwen3MoE) \
        and all(torch.equal(auto["layers"][k], seed0["layers"][k])
                for k in seed0["layers"])
    checks["odd_width_raises"] = _raises(
        lambda: Qwen3MoE(dataclasses.replace(
            arch, moe_intermediate_size=4 * n + 1), TPContext(mesh),
            device="cpu"), ValueError, "not divisible")


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
        inp = np.load(inputs)
        if part == "ops":
            _ops(inp, mesh, out)
        else:
            _model(inp, mesh, out, checks)
        dist.barrier()
        checks["error"] = None
    except BaseException:
        checks["error"] = traceback.format_exc()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(checks, f)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:])
