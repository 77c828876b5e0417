"""The port's ContinuousEngine against the JAX package's, at world 1:
decode_steps K (one program of K masked steps per harvest), cancellation,
preemption with exact replay, and request deadlines.

Each case runs on both engines (tests/torch_continuous_cases.py): the
same paged cache state, slots, queue, prefix index and counters after
every operation, identical greedy tokens per request, and the reference
test's own claims against the port's static Engine. Sampling with
temperature > 0 waits for ROADMAP A2 and raises.
"""

import pytest

from conftest import needs_interpreter
from torch_continuous_cases import (
    both, static, out, models,
)

from triton_dist_tpu_torch.models import ContinuousEngine

pytestmark = needs_interpreter()


def test_decode_steps_parity():
    """decode_steps K = 1, 4, 8: identical greedy outputs (one program
    of K masked steps per harvest); sampling waits for ROADMAP A2."""
    res = both("decode_steps")
    assert res[4] == res[1] and res[8] == res[1]
    _, _, tmodel, tparams = models("dense")
    with pytest.raises(NotImplementedError, match="ROADMAP A2"):
        ContinuousEngine(tmodel, tparams, max_batch=2, temperature=0.8)


def test_cancel_releases_slot_and_pages():
    res = both("cancel")
    assert res["cancel_queued"] and res["cancel_running"]
    assert res["done1"] == [(1, static((2, 7, 1), 4), 0, False)]
    assert res["cancel_finished"] and res["mid_prefill"]
    assert res["cancel_prefill"] and res["reclaimed"]
    assert out(res, "done2") == [static((8, 2, 8), 4)]


def test_preempt_exact_replay():
    """Greedy replay after preemption (mid-decode and mid-chunked-
    prefill) is exact; the sampled half waits for ROADMAP A2."""
    res = both("preempt")
    assert 0 < res["emitted"] < 8 and res["preempt"] and res["again"]
    assert out(res) == [static((3, 1, 4, 1, 5), 8), static((2, 7, 1), 4)]
    assert res["preemptions"] == 1 and res["mid_prefill"]
    assert out(res, "done2") == [
        static((3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8), 4)]


def test_request_timeout_frees_slot():
    res = both("timeout")
    by_uid = {o[0]: o for o in res["done"]}
    assert by_uid[0][3] and 0 < len(by_uid[0][1]) < 30
    assert by_uid[2][3] and by_uid[2][1] == []
    assert not by_uid[1][3] and by_uid[1][1] == static((2, 7, 1), 4)
    assert res["timed_out"] == 2 and res["cancelled"] == 0
