"""The mega decode program (the reference's mega/): a decode step recorded
as a task graph (task.py, builder.py), ordered by a schedule policy
(scheduler.py) and run per method tier (runtime.py); on the card the whole
step is captured once as a CUDA graph and replayed per token
(models/engine.py)."""
