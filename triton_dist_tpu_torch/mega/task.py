"""Task system (the reference's mega/task.py).

A Task is a host-side node of a dataflow graph: its inputs and outputs are
NAMES in the step's tensor environment, and dependencies follow from name
use. Each task has a base function (the "xla" tier: plain PyTorch) and
optionally one per other tier ("pallas_chain": the hand-written kernels)
with the same (inputs) -> (outputs) contract.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class Task:
    """One op of the mega step. ``is_comm`` marks tasks that move bytes
    across ranks (at world 1 the collective is the identity, but the mark
    stays: the comm_aware policy orders by it)."""
    task_type: str
    task_id: int
    layer_id: int
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]
    fn: Callable[..., Any]          # (tensor env values) -> output values
    tier_fns: dict[str, Callable] | None = None
    is_comm: bool = False

    def fn_for(self, tier: str | None) -> Callable[..., Any]:
        if tier and self.tier_fns and tier in self.tier_fns:
            return self.tier_fns[tier]
        return self.fn


class TaskGraph:
    """Append-only task list + name -> producer index."""

    def __init__(self):
        self.tasks: list[Task] = []
        self.producer: dict[str, int] = {}

    def add(self, task_type: str, layer_id: int, inputs: tuple[str, ...],
            outputs: tuple[str, ...], fn, tier_fns: dict | None = None,
            is_comm: bool = False) -> Task:
        # the env is SSA: a name produced twice (by an earlier task or
        # twice in this task's outputs) would make readers order-dependent
        # once the scheduler reorders, so it is refused here
        if len(set(outputs)) != len(outputs):
            dupes = sorted({n for n in outputs if outputs.count(n) > 1})
            raise ValueError(
                f"task {task_type!r} declares duplicate output name(s) "
                f"{dupes} — one env slot cannot hold two values (WAW)")
        for name in outputs:
            if name in self.producer:
                raise ValueError(
                    f"tensor '{name}' already produced by task "
                    f"{self.producer[name]} — re-defining an output name "
                    "is a WAW hazard (readers become order-dependent)")
        t = Task(task_type, len(self.tasks), layer_id, inputs, outputs, fn,
                 tier_fns, is_comm)
        self.tasks.append(t)
        for name in outputs:
            self.producer[name] = t.task_id
        return t

    def deps(self, task: Task) -> list[int]:
        """Producer task ids this task reads."""
        return sorted({self.producer[name] for name in task.inputs
                       if name in self.producer})

    def metrics(self) -> dict:
        """Graph-shape metrics: task and comm-task counts."""
        return {"tasks": len(self.tasks),
                "comm_tasks": sum(t.is_comm for t in self.tasks)}
