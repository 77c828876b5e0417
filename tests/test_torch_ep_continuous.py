"""The expert-parallel MoE model served by the PyTorch port's
ContinuousEngine, against the JAX package: the JAX test_continuous_moe_ep
(tests/test_continuous.py) at world 2.

Two gloo ranks (tests/torch_ep_worker.py, part "cont2") each build the
ContinuousEngine on their rank's EP shard of ``tiny_qwen3_moe(num_layers=1,
tp=2, num_experts=4, topk=2)`` with ``moe_parallel="ep"``, f32 (its paged
mega graph's xla tier on the CPU: the moe task all-gathers the expert
slabs), and serve the JAX test's two requests; the JAX ContinuousEngine
serves them on a 2-device mesh here. Held: every rank's greedy tokens are
the JAX engine's, and no rank's own token differed from rank 0's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_ep_cases import flatten, run
from triton_dist_tpu.layers import TPContext as JTPContext
from triton_dist_tpu.models import ContinuousEngine as JContinuousEngine
from triton_dist_tpu.models import Qwen3MoE as JQwen3MoE
from triton_dist_tpu.models import init_random_params as jinit
from triton_dist_tpu.models import tiny_qwen3_moe as jtiny_moe
from triton_dist_tpu.runtime import make_comm_mesh

REQUESTS = (([3, 1, 4, 1], 4), ([2, 7], 3))


@pytest.fixture(scope="module")
def cont2(tmp_path_factory):
    mesh2 = make_comm_mesh(axes=[("tp", 2)], devices=jax.devices()[:2])
    arch = dataclasses.replace(
        jtiny_moe(num_layers=1, tp=2, num_experts=4, topk=2),
        moe_parallel="ep")
    ctx = JTPContext(mesh2, "tp")
    params = jinit(jax.random.PRNGKey(3), arch, ctx, jnp.float32)
    inp = {f"cparam/{k}": v for k, v in flatten(
        jax.tree_util.tree_map(np.asarray, params)).items()}

    def jax_side():
        eng = JContinuousEngine(JQwen3MoE(arch, ctx, max_length=64,
                                          dtype=jnp.float32), params,
                                max_batch=2, temperature=0.0, page_size=8)
        for prompt, gen in REQUESTS:
            eng.submit(prompt, max_new_tokens=gen)
        return [list(map(int, d.out)) for d in eng.run()]

    want, _, checks = run(tmp_path_factory.mktemp("ep_cont2"), "cont2", inp,
                          jax_side, world=2)
    return want, checks


def test_continuous_moe_ep_equals_jax(cont2):
    want, checks = cont2
    assert [len(o) for o in want] == [g for _, g in REQUESTS]
    for r, c in enumerate(checks):
        assert c["outs"] == want, f"rank {r}"
        assert c["own_token_differs"] == 0
        assert c["mega"] == "xla"
