"""One rank of the tensor-parallel ContinuousEngine parity tests
(tests/test_torch_continuous_tp.py): B9 (ring reduce-scatter), B7 (ring
all-gather), TWO_SHOT, the ContinuousEngine in modes xla (the mega
default) and triton_dist_AR under TWO_SHOT (also on 1- and 2-token
chunks), and the paged Engine, at world n.

    python tests/torch_continuous_worker.py RANK WORLD STORE INPUTS OUTDIR

Joins a gloo process group of WORLD ranks through a FileStore at STORE,
runs the port on the CPU over the inputs in INPUTS (an .npz the test
writes: the JAX model's global parameters, the op inputs, the prompts),
and writes this rank's arrays to OUTDIR/rank<RANK>.npz and its records to
OUTDIR/rank<RANK>.json. Imports torch and the port, never JAX.
``run_script`` runs the scenario on an engine; both sides of the test use it.
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

from triton_dist_tpu_torch.kernels.allgather import (  # noqa: E402
    AllGatherMethod, all_gather_per_device,
)
from triton_dist_tpu_torch.kernels.allreduce import (  # noqa: E402
    AllReduceMethod, all_reduce_per_device,
)
from triton_dist_tpu_torch.kernels.reduce_scatter import (  # noqa: E402
    ReduceScatterMethod, reduce_scatter_per_device,
)
from triton_dist_tpu_torch.layers import TPContext  # noqa: E402
from triton_dist_tpu_torch.models import (  # noqa: E402
    ContinuousEngine, Engine, Qwen3, params_from_numpy, tiny_qwen3,
)
from triton_dist_tpu_torch.runtime import mesh as tp_mesh  # noqa: E402

LAYERS, MAX_LEN = 1, 64
STATE = ("block_table", "lengths", "ref_count", "free_stack", "next_free",
         "overflow")
ENGINE_KW = dict(max_batch=4, page_size=8, prefill_chunk=8, decode_steps=2,
                 prefix_cache=True)
PRE = [3, 1, 4, 1, 5, 9, 2, 6]
# every prefill chunk has >= 3 tokens (a bucket of >= 4 rows: TWO_SHOT
# needs the world to divide the rows); the third request arrives once the
# first one's prompt is indexed, and adopts its first page
SCRIPT = (("submit", PRE + [7, 9, 3], 4),
          ("submit", [2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4], 3),
          ("step", 2),
          ("submit", PRE + [1, 1, 2, 3, 5], 3),
          ("run",))
# chunks a row-split all-reduce cannot split without padding: a 1-token
# and a 2-token prompt, and a prompt whose last chunk holds 1 token
SHORT = (("submit", [5], 3),
         ("submit", [4, 2], 2),
         ("submit", PRE + [6], 3),
         ("run",))


def run_script(eng, script=SCRIPT):
    """Drive ``eng`` (either package's ContinuousEngine) through
    ``script``; returns (the cache state, slots and counters after every
    step, every finished request's (uid, tokens, adopted pages))."""
    trace = []

    def step():
        eng.step()
        st = eng.stats()
        trace.append({
            **{k: np.asarray(getattr(eng.cache, k)).tolist() for k in STATE},
            "slots": [None if r is None else r.uid for r in eng.slots],
            **{k: st[k] for k in ("prefill_chunks", "decode_batches",
                                  "prefix_pages_adopted", "tokens_out")}})

    for op in script:
        if op[0] == "submit":
            eng.submit(list(op[1]), max_new_tokens=op[2])
        elif op[0] == "step":
            for _ in range(op[1]):
                step()
        else:
            while eng.queue or any(r is not None for r in eng.slots):
                step()
    done = sorted(eng.finished, key=lambda r: r.uid)
    return trace, [[r.uid, [int(t) for t in r.out], r.adopted_pages]
                   for r in done]


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


def _ops(inp, mesh, out: dict, checks: dict) -> None:
    r, n = mesh.rank, mesh.world
    x = torch.from_numpy(inp["rs_x"][r])
    y = torch.from_numpy(inp["ag_x"][r])
    out["rs/ring"] = reduce_scatter_per_device(
        n, ReduceScatterMethod.RING_1D, x, mesh=mesh).numpy()
    out["rs/auto"] = reduce_scatter_per_device(
        n, ReduceScatterMethod.AUTO, x, mesh=mesh).numpy()
    out["ag/ring"] = all_gather_per_device(
        n, AllGatherMethod.RING_1D, y, mesh=mesh).numpy()
    out["ag/xla"] = all_gather_per_device(
        n, AllGatherMethod.XLA, y, mesh=mesh).numpy()
    out["ar/two_shot"] = all_reduce_per_device(
        n, AllReduceMethod.TWO_SHOT, x, mesh=mesh).numpy()
    bad = torch.from_numpy(inp["bad_x"][r])
    checks["n_not_dividing_rows_raises"] = all([
        _raises(lambda: all_reduce_per_device(n, AllReduceMethod.TWO_SHOT,
                                              bad, mesh=mesh),
                ValueError, "divisible by the world"),
        _raises(lambda: reduce_scatter_per_device(
            n, ReduceScatterMethod.RING_1D, bad, mesh=mesh),
            ValueError, "divisible by the world")])
    # FULL_MESH (B8's plain version on the CPU) gathers the XLA rows
    checks["full_mesh_equals_xla"] = bool(torch.equal(
        all_gather_per_device(n, AllGatherMethod.FULL_MESH, y, mesh=mesh),
        all_gather_per_device(n, AllGatherMethod.XLA, y, mesh=mesh)))


def _serves(inp, mesh, out: dict, checks: dict) -> None:
    arch = tiny_qwen3(num_layers=LAYERS, tp=mesh.world)
    raw = _unflatten({k: inp[k] for k in inp.files}, "param/")
    params = params_from_numpy(raw, arch, "cpu", torch.float32,
                               rank=mesh.rank, world=mesh.world)
    for label, kw in (("xla", {}),
                      ("two_shot", {"ar_method": AllReduceMethod.TWO_SHOT})):
        model = Qwen3(arch, TPContext(mesh, **kw), max_length=MAX_LEN,
                      dtype=torch.float32, device="cpu")
        eng = ContinuousEngine(
            model, params, mode="xla" if label == "xla" else
            "triton_dist_AR", **ENGINE_KW)
        trace, done = run_script(eng)
        checks[f"continuous/{label}"] = {
            "trace": trace, "done": done,
            "mega": eng.stats()["mega"],
            "own_token_differs": eng.own_token_differs}
    # TWO_SHOT pads a chunk's bucket to a multiple of the world, so short
    # chunks serve (held to mode xla); a decode batch the world does not
    # divide is refused
    for label, kw in (("xla", {}),
                      ("two_shot", {"ar_method": AllReduceMethod.TWO_SHOT})):
        model = Qwen3(arch, TPContext(mesh, **kw), max_length=MAX_LEN,
                      dtype=torch.float32, device="cpu")
        eng = ContinuousEngine(
            model, params, mode="xla" if label == "xla" else
            "triton_dist_AR", **ENGINE_KW)
        trace, done = run_script(eng, SHORT)
        checks[f"continuous/{label}_short"] = {
            "trace": trace, "done": done,
            "own_token_differs": eng.own_token_differs}
    checks["two_shot_batch_refused"] = _raises(
        lambda: ContinuousEngine(model, params, mode="triton_dist_AR",
                                 **{**ENGINE_KW,
                                    "max_batch": mesh.world + 1}),
        ValueError, "max_batch divisible by the world")
    model = Qwen3(arch, TPContext(mesh), max_length=MAX_LEN,
                  dtype=torch.float32, device="cpu")
    eng = Engine(model, params, cache_mode="paged", page_size=8)
    prompt = torch.from_numpy(inp["prompt"]).long()
    out["paged_engine"] = eng.serve(prompt, 4).numpy()
    out["paged_engine_differs"] = eng.own_token_differs.numpy()


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
        _serves(inp, mesh, out, checks)
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
