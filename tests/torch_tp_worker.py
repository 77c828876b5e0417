"""One rank of the tensor-parallel parity tests (tests/test_torch_tp.py).

    python tests/torch_tp_worker.py RANK WORLD STORE INPUTS OUTDIR

Joins a gloo process group of WORLD ranks through a FileStore at STORE,
runs every case of the port on the CPU over the inputs in INPUTS (an .npz
the test writes: the JAX model's global parameters, the op inputs, the
prompt), and writes this rank's results to OUTDIR/rank<RANK>.npz and its
checks to OUTDIR/rank<RANK>.json. Imports torch and the port, never JAX.
"""

from __future__ import annotations

import json
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from triton_dist_tpu_torch import language as lang  # noqa: E402
from triton_dist_tpu_torch.kernels.allgather_gemm import (  # noqa: E402
    AgGemmMethod, ag_gemm_per_device,
)
from triton_dist_tpu_torch.kernels.gemm_reduce_scatter import (  # noqa: E402
    GemmRsMethod, gemm_rs_per_device,
)
from triton_dist_tpu_torch.layers import TPContext  # noqa: E402
from triton_dist_tpu_torch.mega.models.qwen3 import (  # noqa: E402
    build_qwen3_decode,
)
from triton_dist_tpu_torch.models import (  # noqa: E402
    QWEN3_ARCHS, AutoLLM, Engine, Qwen3, init_random_params,
    params_from_numpy, tiny_qwen3, tiny_qwen3_moe,
)
from triton_dist_tpu_torch.runtime import mesh as tp_mesh  # noqa: E402
from triton_dist_tpu_torch.runtime import symm  # noqa: E402

METHODS = ("xla", "xla_ring", "pallas")
LAYERS, MAX_LEN, GEN = 2, 32, 4


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


def _ops(inp: dict, mesh, out: dict) -> None:
    r, n = mesh.rank, mesh.world
    for kind in ("int", "rand"):
        a = torch.from_numpy(inp[f"ag_a_{kind}"])
        b = torch.from_numpy(inp[f"ag_b_{kind}"])
        m, nl = a.shape[0] // n, b.shape[1] // n
        a_loc, b_loc = a[r * m:(r + 1) * m], b[:, r * nl:(r + 1) * nl]
        for meth in METHODS:
            c, ag = ag_gemm_per_device(n, AgGemmMethod(meth), a_loc,
                                       b_loc.contiguous(), mesh=mesh)
            out[f"ag/{kind}/{meth}/out"] = c.numpy()
            out[f"ag/{kind}/{meth}/ag"] = ag.numpy()
        a = torch.from_numpy(inp[f"rs_a_{kind}"])
        b = torch.from_numpy(inp[f"rs_b_{kind}"])
        kl = a.shape[1] // n
        a_loc = a[:, r * kl:(r + 1) * kl].contiguous()
        b_loc = b[r * kl:(r + 1) * kl]
        for meth in METHODS:
            out[f"rs/{kind}/{meth}"] = gemm_rs_per_device(
                n, GemmRsMethod(meth), a_loc, b_loc, mesh=mesh).numpy()


def _model(inp: dict, mesh, out: dict, checks: dict) -> None:
    arch = tiny_qwen3(num_layers=LAYERS, tp=mesh.world)
    raw = _unflatten({k: inp[k] for k in inp.files}, "param/")
    params = params_from_numpy(raw, arch, "cpu", torch.float32,
                               rank=mesh.rank, world=mesh.world)
    for k, v in params.items():
        if k != "layers":
            out[f"shard/{k}"] = v.numpy()
    for k, v in params["layers"].items():
        out[f"shard/layers/{k}"] = v.numpy()
    ids = torch.from_numpy(inp["ids"]).long()
    b_loc = ids.shape[0] // mesh.world
    rows = slice(mesh.rank * b_loc, (mesh.rank + 1) * b_loc)
    for meth in ("xla_ring", "pallas"):
        ctx = TPContext(mesh, ag_method=AgGemmMethod(meth),
                        rs_method=GemmRsMethod(meth))
        model = Qwen3(arch, ctx, max_length=MAX_LEN, dtype=torch.float32,
                      device="cpu")
        lx, _ = model.inference(params, model.create_kv_cache(ids.shape[0]),
                                ids, mode="xla")
        lt, _ = model.inference(params, model.create_kv_cache(ids.shape[0]),
                                ids[rows], mode="triton_dist")
        out[f"logits/{meth}/xla"] = lx.numpy()
        out[f"logits/{meth}/triton_dist"] = lt.numpy()
        prompt = torch.from_numpy(inp["prompt"]).long()
        out[f"tokens/{meth}/triton_dist"] = Engine(
            model, params, backend="triton_dist").serve(prompt, GEN).numpy()
        out[f"tokens/{meth}/xla"] = Engine(
            model, params, mega="off").serve(prompt, GEN).numpy()
    # rank r's share of the world-1 draw is that draw's TP cut, and the
    # two compute the same logits
    world1 = init_random_params(torch.Generator().manual_seed(5), arch,
                                "cpu", torch.float32)
    mine = init_random_params(torch.Generator().manual_seed(5), arch,
                              "cpu", torch.float32, rank=mesh.rank,
                              world=mesh.world)
    q, kv = arch.q_size // mesh.world, arch.kv_size // mesh.world
    full = world1["layers"]["wqkv"]
    r = mesh.rank
    want = torch.cat([full[..., r * q:(r + 1) * q],
                      full[..., arch.q_size + r * kv:arch.q_size
                           + (r + 1) * kv],
                      full[..., arch.q_size + arch.kv_size + r * kv:
                           arch.q_size + arch.kv_size + (r + 1) * kv]], -1)
    checks["init_wqkv_is_world1_cut"] = bool(
        torch.equal(mine["layers"]["wqkv"], want))
    vl = arch.vocab_size // mesh.world
    checks["init_lm_head_is_world1_cut"] = bool(torch.equal(
        mine["lm_head"], world1["lm_head"][:, r * vl:(r + 1) * vl]))
    m1 = Qwen3(arch, max_length=MAX_LEN, dtype=torch.float32, device="cpu")
    ref, _ = m1.inference(world1, m1.create_kv_cache(ids.shape[0]), ids)
    ctx = TPContext(mesh, ag_method=AgGemmMethod.PALLAS,
                    rs_method=GemmRsMethod.PALLAS)
    mn = Qwen3(arch, ctx, max_length=MAX_LEN, dtype=torch.float32,
               device="cpu")
    lt, _ = mn.inference(mine, mn.create_kv_cache(ids.shape[0]), ids[rows],
                         mode="triton_dist")
    checks["init_tp_logits_err_vs_world1"] = float(
        (lt - ref[rows]).abs().max())
    # AutoLLM passes the mesh and the rank through: this rank's shard of
    # the seed-0 weights, on the mesh's device
    QWEN3_ARCHS["tiny/tp"] = arch
    _, auto = AutoLLM.from_pretrained("tiny/tp", TPContext(mesh))
    seed0 = init_random_params(torch.Generator().manual_seed(0), arch,
                               "cpu", torch.bfloat16, rank=mesh.rank,
                               world=mesh.world)
    checks["autollm_rank_shard"] = all(
        torch.equal(auto["layers"][k], seed0["layers"][k])
        for k in seed0["layers"]) and torch.equal(auto["lm_head"],
                                                  seed0["lm_head"])
    # the bidirectional rings run (B11's and B13b's plain versions for
    # PALLAS_BIDIR) and equal the XLA tiers; what is refused
    a = torch.arange(16.0).reshape(2, 8) + mesh.rank
    rs_a = torch.arange(8.0 * mesh.world).reshape(2 * mesh.world, 4) + \
        mesh.rank
    checks["bidir_equals_xla"] = all(
        torch.equal(ag_gemm_per_device(mesh.world, meth, a, a.T,
                                       mesh=mesh)[0],
                    ag_gemm_per_device(mesh.world, AgGemmMethod.XLA, a, a.T,
                                       mesh=mesh)[0])
        for meth in (AgGemmMethod.XLA_BIDIR, AgGemmMethod.PALLAS_BIDIR)
    ) and all(
        torch.equal(gemm_rs_per_device(mesh.world, meth, rs_a, rs_a.T,
                                       mesh=mesh),
                    gemm_rs_per_device(mesh.world, GemmRsMethod.XLA, rs_a,
                                       rs_a.T, mesh=mesh))
        for meth in (GemmRsMethod.XLA_BIDIR, GemmRsMethod.PALLAS_BIDIR))
    checks["no_mesh_raises"] = _raises(
        lambda: ag_gemm_per_device(mesh.world, AgGemmMethod.XLA, a, a.T),
        ValueError, "needs the mesh")
    model = Qwen3(arch, TPContext(mesh), max_length=MAX_LEN,
                  dtype=torch.float32, device="cpu")
    # the default Engine builds the mega step at world n (its xla tier on
    # the CPU), the MoE family's too (one moe task per layer)
    checks["mega_builds_at_world_n"] = (
        Engine(model, params).mega_tier == "xla"
        and sum(t.task_type == "moe" for t in build_qwen3_decode(
            tiny_qwen3_moe(num_layers=1, tp=mesh.world), mesh.world,
            mesh=mesh).graph.tasks) == 1)
    checks["paged_builds_at_world_n"] = isinstance(
        Engine(model, params, cache_mode="paged"), Engine)
    checks["odd_batch_raises"] = _raises(
        lambda: Engine(model, params, backend="triton_dist").serve(
            torch.zeros((3, 4), dtype=torch.long), 2),
        ValueError, "not divisible")


def _runtime(mesh, checks: dict) -> None:
    buf = symm.symm_zeros(mesh, (2, 3), torch.float32)
    checks["cpu_symm_is_plain"] = (buf.table is None and buf.tensor.shape ==
                                   (2, 3) and float(buf.tensor.abs().sum())
                                   == 0.0)
    x = torch.full((8,), float(mesh.rank + 1))
    lang.barrier_all(mesh)
    got = lang.notify_wait(mesh, x)
    checks["notify_wait_is_rank0"] = bool(torch.equal(got,
                                                      torch.ones(8)))
    checks["rank_world"] = (lang.rank(mesh), lang.num_ranks(mesh),
                            tp_mesh.comm_axis_size(mesh, "tp"))


def main(rank: str, world: str, store: str, inputs: str, outdir: str):
    rank, world = int(rank), int(world)
    torch.manual_seed(0)
    checks: dict = {}
    out: dict = {}
    try:
        tp_mesh.initialize_distributed(f"file://{store}", world, rank,
                                       device="cpu")
        mesh = tp_mesh.make_comm_mesh()
        inp = np.load(inputs)
        _ops(inp, mesh, out)
        _model(inp, mesh, out, checks)
        _runtime(mesh, checks)
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
