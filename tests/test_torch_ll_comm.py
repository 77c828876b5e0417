"""The small collectives and pipeline point-to-point of the PyTorch port
against the JAX package: fast_allgather under every method and its layer,
p2p_put_op, CommOp, ring_shift_op and barrier_all_op.

Four gloo ranks (tests/torch_ll_comm_worker.py) run the port's entry
points on their row shards of numpy inputs made from a seed; the JAX ops
run on the same inputs on ``mesh4`` (their Pallas kernels in interpret
mode), meanwhile, in this process. Every output is held to the JAX
output byte for byte (bf16 as its uint16 bits). World 1, where every op
is the identity, runs in this process with no process group. The host
logic (``_factor_2d``, ``FastAllGatherContext.resolve`` with explicit
methods, the port's own AUTO rule) needs no world.

One difference from the reference is pinned here: the JAX
``fast_allgather`` under FULL_MESH raises on an n-D shard (its full-mesh
per-device entry unpacks ``m, k = xs.shape``); the port's flattens the
shard as the ring methods do, and its rows are held to the JAX XLA
method's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from torch_ll_comm_worker import (
    AG_METHODS,
    COMM_SHIFTS,
    P2P_PAIRS,
    SEND_RECV,
    SHIFTS,
    to_numpy,
    to_torch,
)
from torch_world import run_world
from triton_dist_tpu.kernels import (
    barrier_all_op as jbarrier_all_op,
    p2p_put_op as jp2p_put_op,
    ring_shift_op as jring_shift_op,
)
from triton_dist_tpu.kernels import low_latency_allgather as jll
from triton_dist_tpu.layers import CommOp as JCommOp
from triton_dist_tpu.layers.low_latency_allgather_layer import (
    LowLatencyAllGatherLayer as JLowLatencyAllGatherLayer,
)
from triton_dist_tpu.runtime import make_comm_mesh as jmake_comm_mesh
from triton_dist_tpu_torch.kernels import low_latency_allgather as ll
from triton_dist_tpu_torch.kernels import (
    barrier_all_op,
    p2p_put_op,
    ring_shift_op,
)
from triton_dist_tpu_torch.kernels.p2p import p2p_put_per_device
from triton_dist_tpu_torch.layers import CommOp, LowLatencyAllGatherLayer
from triton_dist_tpu_torch.runtime.mesh import Mesh, make_comm_mesh

WORLD = 4
AG_INPUTS = {"f32_2d": (np.float32, (WORLD * 8, 128)),
             "bf16_2d": (np.uint16, (WORLD * 8, 128)),
             "f32_3d": (np.float32, (WORLD * 4, 8, 16)),
             "bf16_3d": (np.uint16, (WORLD * 4, 8, 16))}


def _draw(rng, dtype, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == np.uint16:
        return x.astype(ml_dtypes.bfloat16).view(np.uint16)
    return x


def _inputs() -> dict:
    rng = np.random.default_rng(2011)
    inp = {f"ag_in/{k}": _draw(rng, dt, shp)
           for k, (dt, shp) in AG_INPUTS.items()}
    inp["x"] = _draw(rng, np.float32, (WORLD * 8, 128))
    return inp


def _jnp(a: np.ndarray):
    """A numpy input as JAX sees it; uint16 arrays are bf16 bits."""
    if a.dtype == np.uint16:
        return jnp.asarray(a.view(ml_dtypes.bfloat16))
    return jnp.asarray(a)


def _bits(a) -> np.ndarray:
    """A JAX output as numpy; bf16 as its uint16 bits."""
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _jax_ag(mesh, method: str, x):
    ctx = jll.create_fast_allgather_context(
        mesh, "tp", method=jll.LLAllGatherMethod(method),
        nx=2 if method == "ring_2d" else None)
    return _bits(jll.fast_allgather(ctx, x))


def _jax_side(mesh4, inp: dict) -> dict:
    """Every case of the worker through the JAX package on mesh4 (the
    CommOp cases on a "pp" mesh of the same devices)."""
    want = {}
    for key in (k for k in inp if k.startswith("ag_in/")):
        x = _jnp(inp[key])
        for name in AG_METHODS:
            try:
                want[f"ag/{name}/{key[6:]}"] = _jax_ag(mesh4, name, x)
            except ValueError as exc:
                want[f"ag/{name}/{key[6:]}"] = exc
    x = _jnp(inp["x"])
    want["layer"] = _bits(JLowLatencyAllGatherLayer.create(mesh4)(x))
    for src, dst in P2P_PAIRS:
        want[f"p2p/{src}_{dst}"] = _bits(jp2p_put_op(mesh4, "tp", x, src,
                                                     dst))
    pp = JCommOp(jmake_comm_mesh(axes=[("pp", WORLD)],
                                 devices=jax.devices()[:WORLD]))
    want["comm/send_recv"] = _bits(pp.send_recv(x, *SEND_RECV))
    for by in COMM_SHIFTS:
        want[f"comm/shift{by}"] = _bits(pp.shift(x, by=by))
    for s in SHIFTS:
        want[f"shift/{s}"] = _bits(jring_shift_op(mesh4, "tp", x, shift=s))
    want["barrier"] = _bits(jbarrier_all_op(mesh4, "tp", x))
    return want


@pytest.fixture(scope="module")
def world4(mesh4, tmp_path_factory):
    """(the inputs, the JAX outputs, the four ranks' outputs and
    checks)."""
    inp = _inputs()
    want, ranks, checks = run_world(
        "torch_ll_comm_worker.py", tmp_path_factory.mktemp("ll_comm4"),
        WORLD, inp, side=lambda: _jax_side(mesh4, inp))
    return inp, want, ranks, checks


def _same_bytes(got: np.ndarray, want: np.ndarray) -> bool:
    return got.shape == want.shape and got.dtype == want.dtype and \
        got.tobytes() == want.tobytes()


def _shards(ranks, key) -> np.ndarray:
    """The ranks' output shards of ``key``, concatenated in rank order."""
    return np.concatenate([r[key] for r in ranks])


@pytest.mark.parametrize("shape", ["2d", "3d"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("method", AG_METHODS)
def test_fast_allgather_equals_jax(world4, method, dtype, shape):
    inp, want, ranks, _ = world4
    key = f"ag/{method}/{dtype}_{shape}"
    ref = want[key]
    if method == "full_mesh" and shape == "3d":
        # the reference raises on an n-D shard; the port gathers it
        assert isinstance(ref, ValueError)
        ref = want[f"ag/xla/{dtype}_{shape}"]
    assert _same_bytes(ref, inp[f"ag_in/{dtype}_{shape}"])
    for r, got in enumerate(ranks):
        assert _same_bytes(got[key], ref), f"rank {r}"


def test_layer_equals_jax(world4):
    _, want, ranks, _ = world4
    for r, got in enumerate(ranks):
        assert _same_bytes(got["layer"], want["layer"]), f"rank {r}"


@pytest.mark.parametrize("src,dst", P2P_PAIRS)
def test_p2p_put_equals_jax(world4, src, dst):
    inp, want, ranks, _ = world4
    key = f"p2p/{src}_{dst}"
    assert _same_bytes(_shards(ranks, key), want[key])
    m = inp["x"].shape[0] // WORLD
    assert _same_bytes(ranks[dst][key], inp["x"][src * m:(src + 1) * m])


@pytest.mark.parametrize("case", ["send_recv",
                                  *(f"shift{by}" for by in COMM_SHIFTS)])
def test_comm_op_equals_jax(world4, case):
    _, want, ranks, _ = world4
    assert _same_bytes(_shards(ranks, f"comm/{case}"), want[f"comm/{case}"])


@pytest.mark.parametrize("shift", SHIFTS)
def test_ring_shift_equals_jax(world4, shift):
    inp, want, ranks, _ = world4
    key = f"shift/{shift}"
    assert _same_bytes(_shards(ranks, key), want[key])
    rolled = np.roll(inp["x"].reshape(WORLD, -1, 128), shift, axis=0)
    assert _same_bytes(want[key], rolled.reshape(inp["x"].shape))


def test_barrier_all_passes_x_through(world4):
    inp, want, ranks, _ = world4
    assert _same_bytes(_shards(ranks, "barrier"), want["barrier"])
    assert _same_bytes(want["barrier"], inp["x"])


def test_cpu_ranks_launch_no_kernel(world4):
    *_, checks = world4
    for r, c in enumerate(checks):
        assert c["error"] is None, f"rank {r}"
        assert not any(c["launches"].values()), f"rank {r}: {c['launches']}"


# -- world 1: every op is the identity, no process group ---------------------

WORLD1_OPS = (*(f"ag_{m}" for m in AG_METHODS), "layer", "p2p", "shift",
              "barrier", "comm_shift", "comm_send_recv")


def _world1(op: str, mesh, pp, x):
    """Op ``op`` at world 1 through either package (mesh, pp: its "tp"
    and "pp" meshes; a JAX mesh takes the JAX package)."""
    jax_side = not isinstance(mesh, Mesh)
    if op.startswith("ag_"):
        mod = jll if jax_side else ll
        ctx = mod.create_fast_allgather_context(
            mesh, "tp", method=mod.LLAllGatherMethod(op[3:]))
        return mod.fast_allgather(ctx, x)
    if op == "layer":
        cls = JLowLatencyAllGatherLayer if jax_side else \
            LowLatencyAllGatherLayer
        return cls.create(mesh)(x)
    if op == "p2p":
        return (jp2p_put_op if jax_side else p2p_put_op)(mesh, "tp", x, 0, 0)
    if op == "shift":
        return (jring_shift_op if jax_side else ring_shift_op)(
            mesh, "tp", x, shift=1)
    if op == "barrier":
        return (jbarrier_all_op if jax_side else barrier_all_op)(mesh, "tp",
                                                                 x)
    comm = (JCommOp if jax_side else CommOp)(pp)
    return comm.shift(x, by=1) if op == "comm_shift" else \
        comm.send_recv(x, 0, 0)


@pytest.mark.parametrize("op", WORLD1_OPS)
def test_world1_is_identity(op):
    x = _draw(np.random.default_rng(7), np.float32, (8, 128))
    devs = jax.devices()[:1]
    want = _bits(_world1(op, jmake_comm_mesh(axes=[("tp", 1)], devices=devs),
                         jmake_comm_mesh(axes=[("pp", 1)], devices=devs),
                         jnp.asarray(x)))
    got = to_numpy(_world1(op, make_comm_mesh(),
                           make_comm_mesh(axes=[("pp", 1)]), to_torch(x)))
    assert _same_bytes(want, x)
    assert _same_bytes(got, want)


# -- host logic --------------------------------------------------------------

@pytest.mark.parametrize("n", [4, 7, 8, 12, 16])
def test_factor_2d_equals_jax(n):
    assert ll._factor_2d(n) == jll._factor_2d(n)


@dataclasses.dataclass
class _JaxMeshStub:
    """What the JAX resolve reads of a mesh: its axis sizes."""
    shape: dict


def _stub(world: int, device: str = "cpu") -> Mesh:
    return Mesh(None, "tp", 0, world, torch.device(device))


@pytest.mark.parametrize("world", range(1, 9))
def test_resolve_explicit_equals_jax(world):
    """Every explicit method, RING_2D's nx unset, 1, 2 and 3: the port's
    resolve is the reference's (RING_2D on a world that does not factor
    by nx takes BIDIR_RING)."""
    for method in ll.LLAllGatherMethod:
        if method == ll.LLAllGatherMethod.AUTO:
            continue
        for nx in (None, 1, 2, 3):
            got = ll.FastAllGatherContext(_stub(world), "tp", method,
                                          nx).resolve(4096)
            want = jll.FastAllGatherContext(
                _JaxMeshStub({"tp": world}), "tp",
                jll.LLAllGatherMethod(method.value), nx).resolve(4096)
            assert got.value == want.value, (method, nx)


def test_auto_resolves_to_xla_off_the_card_and_at_world_1():
    auto = ll.LLAllGatherMethod.AUTO
    for nbytes in (1024, 1 << 20, 1 << 30):
        assert ll.FastAllGatherContext(_stub(4), "tp", auto).resolve(
            nbytes) == ll.LLAllGatherMethod.XLA
        assert ll.FastAllGatherContext(_stub(1, "cuda"), "tp", auto).resolve(
            nbytes) == ll.LLAllGatherMethod.XLA


def test_auto_on_the_card_is_the_ports_rule():
    """The card-derived rule: FULL_MESH up to LL_FULL_MESH_MAX_SHARD_BYTES
    (and at a world of 2), the reference's choice of ring above; resolve
    on a CUDA mesh follows it."""
    big = ll.LL_FULL_MESH_MAX_SHARD_BYTES + 1
    rule = ll.get_auto_ll_allgather_method
    full = ll.LLAllGatherMethod.FULL_MESH
    bidir = ll.LLAllGatherMethod.BIDIR_RING
    assert rule(10 * 1024, 4) == full
    assert rule(ll.LL_FULL_MESH_MAX_SHARD_BYTES, 8) == full
    assert rule(big, 2) == full
    assert rule(big, 4) == bidir            # 2 + 2 - 2 hops is not < 4 / 2
    assert rule(big, 7) == bidir            # prime: no 2-D factoring
    assert rule(big, 16) == ll.LLAllGatherMethod.RING_2D
    ctx = ll.FastAllGatherContext(_stub(4, "cuda"), "tp",
                                  ll.LLAllGatherMethod.AUTO)
    for nbytes in (10 * 1024, big):
        assert ctx.resolve(nbytes) == rule(nbytes, 4)


def test_bad_ranks_and_row_widths_raise():
    x = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="ranks of a world of 1"):
        p2p_put_per_device(make_comm_mesh(), x, 0, 1)
    with pytest.raises(ValueError, match="must be > 1 and divide"):
        ll.ring2d_ag_per_device(_stub(4), x, 3)
    with pytest.raises(ValueError, match="unresolved method"):
        ll.ll_allgather_per_device(4, ll.LLAllGatherMethod.FULL_MESH, None,
                                   x, mesh=_stub(4))
