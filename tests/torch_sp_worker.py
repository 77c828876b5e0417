"""One rank of the sequence-parallel parity tests (tests/test_torch_sp_*.py).

    python tests/torch_sp_worker.py RANK WORLD STORE INPUTS OUTDIR PART

Joins a gloo process group of WORLD ranks through a FileStore at STORE,
runs the cases of PART on the CPU over the global inputs in INPUTS (an
.npz the test writes; each rank takes its own shard) and writes this
rank's results to OUTDIR/rank<RANK>.npz and its checks to
OUTDIR/rank<RANK>.json. PART "prefill": ``sp_attention`` under every
method, contiguous (XLA_BLOCK and PALLAS at comm_blocks 1 and 4);
"zigzag": the ring methods over the zigzag layout, dense and packed
varlen; "varlen": the packed-varlen tiers and the refusals;
"decode": ``flash_decode`` under both combines, local methods and
kv_splits, ``paged_flash_decode_dist`` (f32 and int8 pools) and the
unnormalized PALLAS combine; "layer": ``SpGQAFlashDecodeAttention``'s
prefill then decode, its per-device twins and the paged decode. Imports
torch and the port, never JAX.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_sp_cases import (  # noqa: E402
    BLOCKS, DEC_CASES, DEC_OFFSET, PRE_METHODS, VAR_CU, VAR_METHODS,
    ZIGZAG_METHODS,
)
from torch_world import finish  # noqa: E402
from triton_dist_tpu_torch.kernels import launch_counts  # noqa: E402
from triton_dist_tpu_torch.kernels.flash_decode import (  # noqa: E402
    FlashDecodeCombine, create_flash_decode_context, flash_decode,
    flash_decode_2d_per_device, paged_flash_decode_dist,
    pallas_combine_per_device, tree_lse_partial_merge,
)
from triton_dist_tpu_torch.kernels.sp_ag_attention import (  # noqa: E402
    SpAttnMethod, create_sp_attn_context, sp_attention, zigzag_shard,
)
from triton_dist_tpu_torch.layers import (  # noqa: E402
    SpGQAFlashDecodeAttention,
)
from triton_dist_tpu_torch.runtime import mesh as tp_mesh  # noqa: E402


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _shard(x: torch.Tensor, mesh, axis: int = 1) -> torch.Tensor:
    n = x.shape[axis] // mesh.world
    return x.narrow(axis, mesh.rank * n, n).contiguous()


def _raises(fn, exc, match: str) -> bool:
    try:
        fn()
    except exc as e:
        return match in str(e)
    return False


def _qkv(inp, prefix, mesh, zigzag=False):
    xs = [_t(inp[f"{prefix}{x}"]) for x in "qkv"]
    if zigzag:
        xs = [zigzag_shard(x, mesh.world) for x in xs]
    return [_shard(x, mesh) for x in xs]


def _sp(mesh, method, q, k, v, **kw):
    cu = kw.pop("cu", None)
    ctx = create_sp_attn_context(mesh, axis="tp",
                                 method=SpAttnMethod(method), **kw)
    return sp_attention(ctx, q, k, v, cu_seqlens=cu).numpy()


def _prefill(inp, mesh, out: dict, checks: dict) -> None:
    q, k, v = _qkv(inp, "", mesh)
    for method in PRE_METHODS:
        cbs = BLOCKS if method in ("xla_block", "pallas") else (4,)
        for cb in cbs:
            out[f"{method}/cb{cb}"] = _sp(mesh, method, q, k, v,
                                          comm_blocks=cb)
    out["auto"] = _sp(mesh, "auto", q, k, v)
    checks["no_launch_on_cpu"] = not any(launch_counts().values())


def _zigzag(inp, mesh, out: dict, checks: dict) -> None:
    qz, kz, vz = _qkv(inp, "pre/", mesh, zigzag=True)
    for method in ZIGZAG_METHODS:
        out[f"zigzag/{method}"] = _sp(mesh, method, qz, kz, vz,
                                      layout="zigzag")
    qz, kz, vz = _qkv(inp, "big/", mesh, zigzag=True)
    cu = _t(inp["cu/padded"])
    for method in ZIGZAG_METHODS:
        out[f"varlen/{method}"] = _sp(mesh, method, qz, kz, vz, cu=cu,
                                      layout="zigzag")
    checks["no_launch_on_cpu"] = not any(launch_counts().values())


def _varlen(inp, mesh, out: dict, checks: dict) -> None:
    q, k, v = _qkv(inp, "big/", mesh)
    for name in VAR_CU:
        cu = _t(inp[f"cu/{name}"])
        for method in VAR_METHODS:
            out[f"{name}/{method}"] = _sp(mesh, method, q, k, v, cu=cu)
    sq, sk, sv = _qkv(inp, "small/", mesh)
    cu = _t(inp["cu/small"])
    for method in ("xla", "xla_ring"):
        out[f"small/{method}"] = _sp(mesh, method, sq, sk, sv, cu=cu)
    # the reference's refusals, each the same class of error
    ctx = create_sp_attn_context
    checks["flash_ring_head_dim"] = _raises(
        lambda: _sp(mesh, "flash_ring", sq, sk, sv), ValueError,
        "head_dim % 128")
    checks["pallas_head_dim"] = _raises(
        lambda: _sp(mesh, "pallas", sq, sk, sv), ValueError,
        "head_dim % 128")
    checks["pallas_zigzag"] = _raises(
        lambda: _sp(mesh, "pallas", q, k, v, layout="zigzag"), ValueError,
        "contiguous single-slice")
    checks["pallas_cu_seqlens"] = _raises(
        lambda: _sp(mesh, "pallas", q, k, v, cu=cu), ValueError,
        "contiguous single-slice")
    checks["zigzag_xla"] = _raises(
        lambda: _sp(mesh, "xla", q, k, v, layout="zigzag"), ValueError,
        "requires a ring method")
    checks["zigzag_xla_block"] = _raises(
        lambda: _sp(mesh, "xla_block", q, k, v, layout="zigzag"),
        ValueError, "requires a ring method")
    checks["zigzag_odd_rows"] = _raises(
        lambda: _sp(mesh, "xla_ring", q[:, :3], k[:, :3], v[:, :3],
                    layout="zigzag"), ValueError, "even per-rank row")
    checks["xla_block_cu_seqlens"] = _raises(
        lambda: _sp(mesh, "xla_block", q, k, v, cu=cu), ValueError,
        "XLA_BLOCK does not take cu_seqlens")
    checks["unknown_layout"] = _raises(
        lambda: _sp(mesh, "xla_ring", q, k, v, layout="striped"),
        ValueError, "unknown layout")
    checks["sp_dcn_axis_a9"] = _raises(
        lambda: ctx(mesh, axis="tp", dcn_axis="dcn"), ValueError,
        "ROADMAP A9 (tail)")
    checks["no_launch_on_cpu"] = not any(launch_counts().values())


def _decode(inp, mesh, out: dict, checks: dict) -> None:
    r = mesh.rank
    q = _t(inp["q"])
    k, v = _shard(_t(inp["k"]), mesh), _shard(_t(inp["v"]), mesh)
    for combine, local, splits in DEC_CASES:
        ctx = create_flash_decode_context(
            mesh, axis="tp", combine=FlashDecodeCombine(combine),
            local_method=local, kv_splits=splits)
        key = f"{combine}/{local}/s{splits}"
        out[f"dense/{key}"] = flash_decode(ctx, q, k, v, DEC_OFFSET).numpy()
        # the position as a 0-d int32 tensor, as a captured step passes it
        out[f"dense_t/{key}"] = flash_decode(
            ctx, q, k, v, torch.tensor(DEC_OFFSET, dtype=torch.int32)).numpy()
    pq = _t(inp["pq"])
    tab, ln = _t(inp["table"][r]), _t(inp["lengths"][r])
    for combine in ("xla", "pallas"):
        ctx = create_flash_decode_context(
            mesh, axis="tp", combine=FlashDecodeCombine(combine))
        out[f"paged/{combine}"] = paged_flash_decode_dist(
            ctx, pq, _t(inp["kp"][r]), _t(inp["vp"][r]), tab, ln).numpy()
        out[f"paged_int8/{combine}"] = paged_flash_decode_dist(
            ctx, pq, _t(inp["kp_i8"][r]), _t(inp["vp_i8"][r]), tab, ln,
            k_scales=_t(inp["ks"][r]), v_scales=_t(inp["vs"][r])).numpy()
    # B20's plain version, unnormalized: every rank the same merged triple
    g = torch.Generator().manual_seed(7)
    acc = torch.randn((2, 4, 128), generator=g) + r
    m = torch.randn((2, 4), generator=g) - r
    m[0, 0] = -1e30 if r else m[0, 0]
    l = torch.rand((2, 4), generator=g) + (0.0 if r else 1.0)
    for i, x in enumerate(pallas_combine_per_device(mesh, acc, m, l,
                                                    partial=True)):
        out[f"partial/{i}"] = x.numpy()
    out["partial_in/acc"], out["partial_in/m"], out["partial_in/l"] = \
        acc.numpy(), m.numpy(), l.numpy()
    checks["fd_dcn_axis_a9"] = _raises(
        lambda: create_flash_decode_context(mesh, axis="tp",
                                            dcn_axis="dcn"),
        ValueError, "ROADMAP A9 (tail)")
    checks["tree_merge_a9"] = _raises(
        lambda: tree_lse_partial_merge("dcn", 2, acc, m, l), ValueError,
        "ROADMAP A9 (tail)")
    checks["decode_2d_a9"] = _raises(
        lambda: flash_decode_2d_per_device("tp", "dcn", 4, 2), ValueError,
        "ROADMAP A9 (tail)")
    checks["unknown_local_method"] = _raises(
        lambda: flash_decode(create_flash_decode_context(
            mesh, axis="tp", local_method="cuda"), q, k, v, DEC_OFFSET),
        ValueError, "unknown local decode method")
    checks["wrong_axis"] = _raises(
        lambda: flash_decode(create_flash_decode_context(mesh, axis="sp"),
                             q, k, v, DEC_OFFSET), ValueError, "axis")
    checks["no_launch_on_cpu"] = not any(launch_counts().values())


def _layer(inp, mesh, out: dict, checks: dict) -> None:
    t = inp["q"].shape[1] - 1
    q, k, v = (_t(inp[x]) for x in "qkv")
    qs, ks, vs = (_shard(x[:, :t], mesh) for x in (q, k, v))
    kc, vc = _shard(_t(inp["k_cache"]), mesh), _shard(_t(inp["v_cache"]),
                                                      mesh)
    for combine in ("xla", "pallas"):
        for prefill in ("auto", "xla_block"):
            layer = SpGQAFlashDecodeAttention.create(
                mesh, axis="tp", combine=FlashDecodeCombine(combine),
                prefill=SpAttnMethod(prefill))
            key = f"{combine}/{prefill}"
            out[f"prefill/{key}"] = layer.prefill(qs, ks, vs).numpy()
            out[f"prefill_pd/{key}"] = layer.prefill_per_device(
                qs, ks, vs).numpy()
            out[f"decode/{key}"] = layer.decode(q[:, t], kc, vc, t).numpy()
            out[f"decode_pd/{key}"] = layer.decode_per_device(
                q[:, t], kc, vc, torch.tensor(t, dtype=torch.int32)).numpy()
    # the paged decode through the layer: this rank's keys of each
    # sequence as one page
    b, s_loc = kc.shape[0], kc.shape[1]
    n_live = max(0, min(s_loc, t + 1 - mesh.rank * s_loc))
    pages = kc.permute(2, 0, 1, 3)           # (Hkv, B pages, s_loc, D)
    vpages = vc.permute(2, 0, 1, 3)
    table = torch.arange(b, dtype=torch.int32)[:, None]
    lengths = torch.full((b,), n_live, dtype=torch.int32)
    for combine in ("xla", "pallas"):
        layer = SpGQAFlashDecodeAttention.create(
            mesh, axis="tp", combine=FlashDecodeCombine(combine))
        out[f"paged/{combine}"] = layer.decode_paged(
            q[:, t], pages.contiguous(), vpages.contiguous(), table,
            lengths).numpy()
        out[f"paged_pd/{combine}"] = layer.decode_paged_per_device(
            q[:, t], pages.contiguous(), vpages.contiguous(), table,
            lengths).numpy()
    checks["layer_dcn_axis_a9"] = _raises(
        lambda: SpGQAFlashDecodeAttention.create(mesh, axis="tp",
                                                 dcn_axis="dcn"),
        ValueError, "ROADMAP A9 (tail)")
    checks["no_launch_on_cpu"] = not any(launch_counts().values())


PARTS = {"prefill": _prefill, "zigzag": _zigzag, "varlen": _varlen,
         "decode": _decode, "layer": _layer}


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
