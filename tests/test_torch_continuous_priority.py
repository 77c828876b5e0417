"""The port's ContinuousEngine against the JAX package's, at world 1: the
priority class of the queue (FIFO among priority requests, a priority
arrival that page pressure blocks preempting the victim with the most
budget left, and one handed a preempted slot).

Each case runs on both engines (tests/torch_continuous_cases.py): the
same paged cache state, slots, queue, prefix index and counters after
every operation, identical greedy tokens per request, and the reference
test's own claims against the port's static Engine.
"""

from conftest import needs_interpreter
from torch_continuous_cases import both, out, static

pytestmark = needs_interpreter()


def test_priority_fifo_and_page_blocked_preemption():
    res = both("priority_fifo")
    assert res["fifo"] and res["progress"] and res["order2"] == [1, 0]
    assert out(res, "done2") == [static((3, 1, 4, 1, 5), 9),
                                  static((2, 7, 1, 8, 2), 9)]


def test_priority_preempt_hands_slot_to_arrival():
    res = both("priority_preempt")
    assert res["preempt"] and res["queue"] and res["order"] == [1, 0]
    assert out(res) == [static((3, 1, 4, 1, 5), 8), static((2, 7, 1), 3)]
