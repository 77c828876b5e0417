"""Task scheduler (the reference's mega/scheduler.py, pure Python, copied
and adapted).

A schedule is one linear topological order of the task ids: tasks run only
after their producers. The policies are the reference's, so the same graph
gets the same order.
"""

from __future__ import annotations

import heapq

from triton_dist_tpu_torch.mega.task import TaskGraph

POLICIES = ("program", "greedy_width", "comm_aware")


def schedule_tasks(graph: TaskGraph, policy: str = "program") -> list[int]:
    """Return a topological execution order of task ids.

    policy:
      * "program" — builder insertion order (topological because inputs
        must exist when a task is added); verified, not trusted.
      * "greedy_width" — Kahn's algorithm, the ready task with the most
        successors first, ties in program order.
      * "comm_aware" — Kahn's algorithm, ready comm tasks (Task.is_comm)
        first, then ``draft_*`` tasks, then greedy width.
    """
    n = len(graph.tasks)
    deps = {t.task_id: set(graph.deps(t)) for t in graph.tasks}

    if policy == "program":
        seen: set[int] = set()
        for t in graph.tasks:
            if not deps[t.task_id] <= seen:
                raise ValueError(
                    f"task {t.task_id} ({t.task_type}) runs before a "
                    f"dependency: {deps[t.task_id] - seen}")
            seen.add(t.task_id)
        return list(range(n))

    if policy in ("greedy_width", "comm_aware"):
        users: dict[int, list[int]] = {i: [] for i in range(n)}
        for t in graph.tasks:
            for d in deps[t.task_id]:
                users[d].append(t.task_id)
        indeg = {i: len(deps[i]) for i in range(n)}

        def key(i: int):
            if policy == "comm_aware":
                t = graph.tasks[i]
                if t.is_comm:
                    cls = 0
                elif t.task_type.startswith("draft"):
                    cls = 1
                else:
                    cls = 2
                return (cls, -len(users[i]), i)
            return (-len(users[i]), i)

        ready = [key(i) for i in range(n) if indeg[i] == 0]
        heapq.heapify(ready)
        order: list[int] = []
        while ready:
            i = heapq.heappop(ready)[-1]
            order.append(i)
            for u in users[i]:
                indeg[u] -= 1
                if indeg[u] == 0:
                    heapq.heappush(ready, key(u))
        if len(order) != n:
            raise ValueError("task graph has a cycle")
        return order

    raise ValueError(f"unknown policy {policy}")
