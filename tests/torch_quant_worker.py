"""One gloo rank of the quantized wire at world n
(tests/test_torch_quant_world.py).

    python tests/torch_quant_worker.py RANK WORLD STORE INPUTS OUTDIR

Every rank joins a gloo group (FileStore rendezvous at STORE), takes its
shard of each input in INPUTS (bf16 arrives as its uint16 bits) and runs
the port's entry points on it: ``all_reduce_per_device`` under QINT8_OS,
QINT8 and QINT8_OS_STOCHASTIC, ``gemm_ar_per_device`` under XLA_QINT8,
``kv_handoff`` / ``kv_handoff_fanout`` / ``kv_handoff_quantized`` under
every method at comm_blocks 1 and 4, the triton_dist_AR logits of
``tiny_qwen3(tp=n)`` under QINT8_OS and its Engine's greedy tokens. It
saves each output in OUTDIR/rank{r}.npz (bf16 as uint16 bits) and the
refusals, branch counts and any error in rank{r}.json.
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

from torch_ar_worker import _raises, _unflatten  # noqa: E402
from torch_ll_comm_worker import shard, to_numpy  # noqa: E402
from torch_world import finish  # noqa: E402
from triton_dist_tpu_torch.kernels import (  # noqa: E402
    kv_handoff,
    kv_handoff_fanout,
    kv_handoff_quantized,
    launch_counts,
)
from triton_dist_tpu_torch.kernels.allreduce import (  # noqa: E402
    AllReduceMethod,
    all_reduce_per_device,
)
from triton_dist_tpu_torch.kernels.gemm_allreduce import (  # noqa: E402
    GemmArMethod,
    gemm_ar_per_device,
)
from triton_dist_tpu_torch.layers import TPContext  # noqa: E402
from triton_dist_tpu_torch.models import (  # noqa: E402
    Engine,
    Qwen3,
    params_from_numpy,
    tiny_qwen3,
)
from triton_dist_tpu_torch.runtime import mesh as tp_mesh  # noqa: E402

AR_METHODS = ("qint8_os", "qint8", "qint8_os_stochastic")
AR_DTYPES = ("f32", "bf16")
GAR_ROWS = (16, 6)          # 6: rows the world does not divide (lossless)
KV_DTYPES = ("f32",)
KV_BLOCKS = (1, 4)
KV_METHODS = ("xla", "pallas", "auto")
HANDOFF_PAIRS = ((0, 3), (2, 1))
FANOUTS = ((0, (1, 2, 3)), (2, (3, 0, 3, 2)))   # duplicates and src dropped
LAYERS, MAX_LEN, GEN = 2, 32, 4


def _ops(inp, mesh, out: dict, checks: dict) -> None:
    r, n = mesh.rank, mesh.world
    for dt in AR_DTYPES:
        x = shard(inp[f"ar/{dt}"], r, n)
        for meth in AR_METHODS:
            out[f"ar/{meth}/{dt}"] = to_numpy(all_reduce_per_device(
                n, AllReduceMethod(meth), x, mesh=mesh))
    b = shard(inp["gar/b"], r, n)
    for m in GAR_ROWS:
        a = torch.from_numpy(inp[f"gar/a{m}"])
        k = a.shape[1] // n
        out[f"gar/{m}"] = gemm_ar_per_device(
            n, GemmArMethod.XLA_QINT8, a[:, r * k:(r + 1) * k].contiguous(),
            b, mesh=mesh).numpy()
    checks["gar_branches"] = dict(gemm_ar_per_device.qint8_branches)
    for dt in KV_DTYPES:
        x = shard(inp[f"kv/{dt}"], r, n)
        for cb in KV_BLOCKS:
            for meth in KV_METHODS:
                tag = f"{dt}/cb{cb}/{meth}"
                for src, dst in HANDOFF_PAIRS:
                    out[f"kv/{src}_{dst}/{tag}"] = to_numpy(kv_handoff(
                        mesh, "tp", x, src, dst, method=meth,
                        comm_blocks=cb))
                for i, (src, dsts) in enumerate(FANOUTS):
                    out[f"fan/{i}/{tag}"] = to_numpy(kv_handoff_fanout(
                        mesh, "tp", x, src, dsts, method=meth,
                        comm_blocks=cb))
                    out[f"qkv/{i}/{tag}"] = to_numpy(kv_handoff_quantized(
                        mesh, "tp", x, src, dsts, method=meth,
                        comm_blocks=cb))
    x = shard(inp["kv/f32"], r, n)
    x6 = torch.ones((6, 16))
    checks["refusals"] = {
        "qint8_rows": _raises(lambda: all_reduce_per_device(
            n, AllReduceMethod.QINT8, x6, mesh=mesh), ValueError,
            "QINT8 needs 2-D x with M divisible"),
        "kv_rank_outside": _raises(lambda: kv_handoff(
            mesh, "tp", x, 0, n), ValueError, "outside the"),
        "fanout_rank_outside": _raises(lambda: kv_handoff_fanout(
            mesh, "tp", x, 0, (1, -1)), ValueError, "outside the"),
        "fanout_empty": _raises(lambda: kv_handoff_fanout(
            mesh, "tp", x, 0, ()), ValueError, "no destination"),
        "quantized_rank2": _raises(lambda: kv_handoff_quantized(
            mesh, "tp", x6, 0, (1,)), ValueError, "rank>=3"),
        "quantized_unknown_codec": _raises(lambda: kv_handoff_quantized(
            mesh, "tp", x, 0, (1,), codec="int8_block"), KeyError,
            "no QuantContract"),
        "src_is_dst_is_x": kv_handoff(mesh, "tp", x, 1, 1) is x
        and kv_handoff_fanout(mesh, "tp", x, 2, (2, 2)) is x}


def _model(inp, mesh, out: dict, checks: dict) -> None:
    arch = tiny_qwen3(num_layers=LAYERS, tp=mesh.world)
    params = params_from_numpy(_unflatten({k: inp[k] for k in inp.files},
                                          "param/"),
                               arch, "cpu", torch.float32, rank=mesh.rank,
                               world=mesh.world)
    model = Qwen3(arch, TPContext(mesh, ar_method=AllReduceMethod.QINT8_OS),
                  max_length=MAX_LEN, dtype=torch.float32, device="cpu")
    ids = torch.from_numpy(inp["ids"]).long()
    logits, _ = model.inference(params, model.create_kv_cache(ids.shape[0]),
                                ids, mode="triton_dist_AR")
    out["logits/qint8_os"] = logits.numpy()
    eng = Engine(model, params, backend="triton_dist_AR")
    out["tokens/qint8_os"] = eng.serve(ids, GEN).numpy()
    out["differs/qint8_os"] = eng.own_token_differs.numpy()


def main(rank: str, world: str, store: str, inputs: str, outdir: str):
    rank, world = int(rank), int(world)
    checks: dict = {}
    out: dict = {}
    try:
        tp_mesh.initialize_distributed(f"file://{store}", world, rank,
                                       device="cpu")
        mesh = tp_mesh.make_comm_mesh()
        inp = np.load(inputs)
        _ops(inp, mesh, out, checks)
        _model(inp, mesh, out, checks)
        checks["launches"] = launch_counts()
        dist.barrier()
        checks["error"] = None
    except BaseException:
        checks["error"] = traceback.format_exc()
    finish(rank, outdir, out, checks)


if __name__ == "__main__":
    main(*sys.argv[1:])
