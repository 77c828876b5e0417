"""One rank of the replicated tensor-parallel parity tests
(tests/test_torch_ar.py): B4 across ranks, B5, B6, the triton_dist_AR mode
and the mega step at world n.

    python tests/torch_ar_worker.py RANK WORLD STORE INPUTS OUTDIR

Joins a gloo process group of WORLD ranks through a FileStore at STORE,
runs the cases of the port on the CPU over the inputs in INPUTS (an .npz
the test writes: the JAX model's global parameters, the op inputs, the
prompt), and writes this rank's results to OUTDIR/rank<RANK>.npz and its
checks to OUTDIR/rank<RANK>.json. Imports torch and the port, never JAX.
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from torch_world import finish  # noqa: E402
from triton_dist_tpu_torch.kernels.allreduce import (  # noqa: E402
    AllReduceMethod, all_reduce_per_device,
)
from triton_dist_tpu_torch.kernels.gemm_allreduce import (  # noqa: E402
    GemmArMethod, gemm_ar_per_device,
)
from triton_dist_tpu_torch.layers import TPContext  # noqa: E402
from triton_dist_tpu_torch.mega.builder import ModelBuilder  # noqa: E402
from triton_dist_tpu_torch.mega.models.qwen3 import (  # noqa: E402
    build_qwen3_decode,
)
from triton_dist_tpu_torch.models import (  # noqa: E402
    Engine, Qwen3, params_from_numpy, tiny_qwen3, tiny_qwen3_moe,
)
from triton_dist_tpu_torch.quant.contract import contract_for  # noqa: E402
from triton_dist_tpu_torch.runtime import mesh as tp_mesh  # noqa: E402

LAYERS, MAX_LEN, GEN = 2, 32, 4
AR_CTX = {"one_shot": {"ar_method": AllReduceMethod.ONE_SHOT},
          "rhd": {"ar_method": AllReduceMethod.RHD},
          "gemm_ar": {"gemm_ar_method": GemmArMethod.PALLAS}}


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


def _ops(inp: dict, mesh, out: dict, checks: dict) -> None:
    r, n = mesh.rank, mesh.world
    for kind in ("int", "rand"):
        for m in (16, 6):
            a = torch.from_numpy(inp[f"gar_a{m}_{kind}"])
            b = torch.from_numpy(inp[f"gar_b_{kind}"])
            kl = a.shape[1] // n
            a_loc = a[:, r * kl:(r + 1) * kl].contiguous()
            b_loc = b[r * kl:(r + 1) * kl].contiguous()
            for meth in ("xla", "pallas"):
                out[f"gar/{kind}/{m}/{meth}"] = gemm_ar_per_device(
                    n, GemmArMethod(meth), a_loc, b_loc, mesh=mesh).numpy()
        x = torch.from_numpy(inp[f"ar_x_{kind}"][r])
        for meth in ("xla", "one_shot", "rhd"):
            out[f"ar/{kind}/{meth}"] = all_reduce_per_device(
                n, AllReduceMethod(meth), x, mesh=mesh).numpy()
    # the mega builder's allreduce task: the process group's sum
    builder = ModelBuilder(mesh)
    builder.add_input("x")
    builder.mark_output(builder.make_allreduce("x", layer_id=0, world=n))
    x = torch.from_numpy(inp["ar_x_int"][r])
    out["builder_allreduce"] = next(iter(
        builder.compile()({"x": x}).values())).numpy()
    x = torch.from_numpy(inp["ar_x_bf16"][r]).to(torch.bfloat16)
    for meth in ("one_shot", "rhd"):
        out[f"ar/bf16/{meth}"] = all_reduce_per_device(
            n, AllReduceMethod(meth), x, mesh=mesh).float().numpy()
    x6, a = torch.ones((6, 8)), torch.ones((4, 8))
    checks["rhd_refusals"] = all([
        _raises(lambda: all_reduce_per_device(n, AllReduceMethod.RHD, x6,
                                              mesh=mesh),
                ValueError, "divisible by the world"),
        _raises(lambda: all_reduce_per_device(3, AllReduceMethod.RHD, a,
                                              mesh=mesh),
                ValueError, "power-of-two")])
    # the int8 wires run (their values are held in
    # tests/test_torch_quant_world.py): here each within its contract of
    # the exact sum of the ranks' all-ones terms, and QINT8 refuses rows
    # the world does not divide, as TWO_SHOT
    def within(op, meth, got, term):
        try:
            contract_for(op, meth).check(n * term, got, [term] * n)
        except AssertionError:
            return False
        return True

    checks["waits_raise"] = all([
        _raises(lambda: gemm_ar_per_device(n, GemmArMethod.XLA_RING, x6,
                                           torch.ones((8, 4)), mesh=mesh),
                ValueError, "divisible by the axis size"),
        within("gemm_ar", "xla_qint8", gemm_ar_per_device(
            n, GemmArMethod.XLA_QINT8, a, a.T, mesh=mesh), a @ a.T),
        _raises(lambda: all_reduce_per_device(n, AllReduceMethod.AUTO, a,
                                              mesh=mesh),
                ValueError, "unresolved method"),
        *(within("allreduce", m_.value, all_reduce_per_device(
            n, m_, a, mesh=mesh), a)
          for m_ in (AllReduceMethod.QINT8, AllReduceMethod.QINT8_OS,
                     AllReduceMethod.QINT8_OS_STOCHASTIC)),
        _raises(lambda: all_reduce_per_device(n, AllReduceMethod.QINT8, x6,
                                              mesh=mesh),
                ValueError, "divisible by the world")])


def _model(inp: dict, mesh, out: dict, checks: dict) -> None:
    arch = tiny_qwen3(num_layers=LAYERS, tp=mesh.world)
    raw = _unflatten({k: inp[k] for k in inp.files}, "param/")
    params = params_from_numpy(raw, arch, "cpu", torch.float32,
                               rank=mesh.rank, world=mesh.world)
    ids = torch.from_numpy(inp["ids"]).long()
    prompt = torch.from_numpy(inp["prompt"]).long()

    def model_of(**kw):
        return Qwen3(arch, TPContext(mesh, **kw), max_length=MAX_LEN,
                     dtype=torch.float32, device="cpu")

    for name, kw in AR_CTX.items():
        model = model_of(**kw)
        logits, _ = model.inference(params, model.create_kv_cache(
            ids.shape[0]), ids, mode="triton_dist_AR")
        out[f"logits/{name}"] = logits.numpy()
    model = model_of()
    out["tokens/mega_pallas_chain"] = Engine(
        model, params, mega="pallas_chain").serve(prompt, GEN).numpy()
    auto = Engine(model, params)
    out["tokens/mega_auto"] = auto.serve(prompt, GEN).numpy()
    checks["mega_auto_tier"] = auto.mega_tier
    ar = Engine(model_of(**AR_CTX["one_shot"]), params,
                backend="triton_dist_AR")
    out["tokens/ar_one_shot"] = ar.serve(prompt, GEN).numpy()
    out["differs/ar_one_shot"] = ar.own_token_differs.numpy()
    checks["moe_task_builds_at_world_n"] = sum(
        t.task_type == "moe" for t in build_qwen3_decode(
            tiny_qwen3_moe(num_layers=1, tp=mesh.world), mesh.world,
            mesh=mesh).graph.tasks) == 1
    paged = Engine(model, params, cache_mode="paged", page_size=8)
    checks["paged_serves_at_world_n"] = bool(np.array_equal(
        paged.serve(prompt, GEN).numpy(), out["tokens/mega_auto"]))


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
        _ops(inp, mesh, out, checks)
        _model(inp, mesh, out, checks)
        dist.barrier()
        checks["error"] = None
    except BaseException:
        checks["error"] = traceback.format_exc()
    finish(rank, outdir, out, checks)


if __name__ == "__main__":
    main(*sys.argv[1:])
