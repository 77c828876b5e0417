"""QuantPolicy: the ``TD_QUANT`` parse, the resident-KV decision, the
mega graph's GEMM+AR wire choice and the expert-parallel dispatch's wire
dtype (the reference's quant/policy.py, the parts the serving paths read).

``TD_QUANT`` is ``off`` (the default) | ``always`` | ``error_budget[:x]``.
The pools stay full width unless the caller passes ``kv_resident="int8"``
or the policy admits the int8 row codec. The EP dispatch payload goes fp8
under ``always``; ``error_budget`` there needs the error contracts
(quant/contract.py) and raises. The other wire-tier gates wait for the
quantized-wire slice (ROADMAP A13).
"""

from __future__ import annotations

import dataclasses
import enum
import os


class QuantPolicy(enum.Enum):
    OFF = "off"                    # lossy tiers are explicit-ask only
    ERROR_BUDGET = "error_budget"  # AUTO may choose them within budget
    ALWAYS = "always"              # AUTO prefers them wherever eligible


# The kv_resident contract's worst-case error: one quantization event (the
# slot write) at the int8 row codec's 1/254 of the row amax.
KV_RESIDENT_REL_BOUND = 1.0 / 254.0

# The gemm_ar xla_qint8 contract (the reference's quant/contract.py): 2n
# quantization events on an n-rank ring, each at the int8 block codec's
# 1/254 of the block amax.
INT8_BLOCK_REL_ERR = 1.0 / 254.0
GEMM_AR_QINT8_EVENTS_PER_RANK = 2


@dataclasses.dataclass(frozen=True)
class PolicyState:
    policy: QuantPolicy = QuantPolicy.OFF
    error_budget: float = 0.0


def parse_td_quant(raw: str) -> PolicyState:
    """Parse a ``TD_QUANT`` value."""
    raw = raw.strip().lower()
    if not raw or raw == "off" or raw == "0":
        return PolicyState()
    if raw == "always" or raw == "1":
        return PolicyState(QuantPolicy.ALWAYS)
    if raw.startswith("error_budget"):
        _, _, budget = raw.partition(":")
        try:
            val = float(budget) if budget else 0.02
        except ValueError:
            raise ValueError(
                f"TD_QUANT={raw!r}: error_budget wants a float after "
                "':' (e.g. error_budget:0.02)") from None
        return PolicyState(QuantPolicy.ERROR_BUDGET, val)
    raise ValueError(f"TD_QUANT={raw!r}: want off | always | "
                     "error_budget[:<float>]")


def resolve_kv_resident(requested: str | None = None,
                        state: PolicyState | None = None) -> str | None:
    """The resident pool codec: "int8" always wins, "off" always loses,
    "auto"/None asks the policy (``state``, else ``TD_QUANT``). Returns
    "kv_int8_row" or None for full-width pools."""
    if requested == "int8":
        return "kv_int8_row"
    if requested == "off":
        return None
    if requested not in (None, "auto"):
        raise ValueError(
            f"kv_resident={requested!r}: want 'auto' | 'int8' | 'off'")
    if state is None:
        state = parse_td_quant(os.environ.get("TD_QUANT", ""))
    if state.policy == QuantPolicy.OFF:
        return None
    if (state.policy == QuantPolicy.ERROR_BUDGET
            and KV_RESIDENT_REL_BOUND > state.error_budget):
        return None
    return "kv_int8_row"


def serving_gemm_ar_method(world: int = 2,
                           state: PolicyState | None = None):
    """The method ``MegaDecodeRuntime`` hands the mega graph's
    linear_allreduce tasks when the caller left it unset: None (AUTO)
    under OFF; the int8 wire (GemmArMethod.XLA_QINT8) under ALWAYS, or
    under ERROR_BUDGET when the contract's bound at ``world`` (never below
    the 2-rank floor) fits the budget. ``state`` defaults to TD_QUANT."""
    if state is None:
        state = parse_td_quant(os.environ.get("TD_QUANT", ""))
    if state.policy == QuantPolicy.OFF:
        return None
    if state.policy == QuantPolicy.ERROR_BUDGET:
        bound = (GEMM_AR_QINT8_EVENTS_PER_RANK * max(int(world), 2)
                 * INT8_BLOCK_REL_ERR)
        if bound > state.error_budget:
            return None
    from triton_dist_tpu_torch.kernels.gemm_allreduce import GemmArMethod
    return GemmArMethod.XLA_QINT8


def resolve_ep_payload_dtype(requested, state: PolicyState | None = None):
    """The expert-parallel dispatch payload's wire dtype: an explicit
    ``requested`` (EpA2AContext.payload_dtype) always wins; with none set,
    OFF keeps the full width (None) and ALWAYS takes fp8 e4m3
    (torch.float8_e4m3fn: the rows per-row quantized, their f32 scales
    beside them). ERROR_BUDGET judges the ep_dispatch contract of
    quant/contract.py, which waits for ROADMAP A13: it raises. ``state``
    defaults to TD_QUANT."""
    if requested is not None:
        return requested
    if state is None:
        state = parse_td_quant(os.environ.get("TD_QUANT", ""))
    if state.policy == QuantPolicy.OFF:
        return None
    if state.policy == QuantPolicy.ERROR_BUDGET:
        raise NotImplementedError(
            "TD_QUANT=error_budget on the expert-parallel dispatch needs the "
            "ep_dispatch error contract (quant/contract.py), which waits for "
            "ROADMAP A13; use TD_QUANT=always or off")
    import torch
    return torch.float8_e4m3fn
