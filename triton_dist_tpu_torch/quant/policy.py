"""QuantPolicy: the one place that decides when lossy wire tiers run (the
reference's quant/policy.py).

  * ``LOSSY_TIERS``: which method values are lossy, per op;
  * ``wire_eligible_methods(op, methods)``: the methods an automatic
    choice may consider: "auto" and every lossy tier dropped, always;
  * ``auto_wire_method``: the explicit upgrade path: whether the policy
    admits a quantized tier for this dispatch (OFF never, ALWAYS whenever
    the shape is eligible, ERROR_BUDGET when the tier's contract bound
    fits the budget and, where the caller passes predicted times, the
    quantized tier is predicted faster; the predictions wait for the
    perf model of ROADMAP A16, and ALWAYS does not read them);
  * ``lossy_fallback_ok``: a lossy tier is never a fallback target, and
    only a policy-selected one may degrade to the lossless twin;
  * the serving paths' decisions: the mega graph's GEMM + AR method
    (``serving_gemm_ar_method``), the KV movers' page codec
    (``resolve_kv_page_codec``), the resident pool's codec
    (``resolve_kv_resident``) and the expert-parallel payload's wire dtype
    (``resolve_ep_payload_dtype``). Each bound is a registered contract's
    (quant/contract.py).

``TD_QUANT`` is ``off`` (the default) | ``always`` | ``error_budget[:x]``.
The process policy is the one installed by ``set_quant_policy``; with none
installed (``reset_quant_policy``) ``TD_QUANT`` is read at each call, so
a change of the variable takes effect at once. Every decision takes an
optional ``state`` (a ``PolicyState``) that overrides both.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from typing import Sequence


class QuantPolicy(enum.Enum):
    OFF = "off"                    # lossy tiers are explicit-ask only
    ERROR_BUDGET = "error_budget"  # AUTO may choose them within budget
    ALWAYS = "always"              # AUTO prefers them wherever eligible


# op -> lossy method values; "quantized" is the EP dispatch payload's
# pseudo-tier (the payload_dtype knob, not an EpA2AMethod member)
LOSSY_TIERS: dict[str, frozenset[str]] = {
    "allreduce": frozenset({"qint8", "qint8_os", "qint8_os_stochastic"}),
    "gemm_ar": frozenset({"xla_qint8"}),
    "ep_dispatch": frozenset({"quantized"}),
    "fast_a2a_q": frozenset({"fp8_row"}),
    "kv_handoff": frozenset({"kv_int8_page", "kv_int8_row"}),
    "kv_resident": frozenset({"kv_int8_row"}),
}


@dataclasses.dataclass(frozen=True)
class PolicyState:
    policy: QuantPolicy = QuantPolicy.OFF
    # the worst-case error the budget mode tolerates, relative to the
    # summed block amaxes (QuantContract.rel_bound's units)
    error_budget: float = 0.0


_STATE: PolicyState | None = None


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


def get_quant_policy() -> PolicyState:
    """The installed policy, else ``TD_QUANT`` as it is now."""
    if _STATE is not None:
        return _STATE
    return parse_td_quant(os.environ.get("TD_QUANT", ""))


def set_quant_policy(policy: QuantPolicy | str,
                     error_budget: float | None = None) -> PolicyState:
    """Install the process policy; returns it. The budget defaults to
    0.02 under ERROR_BUDGET, else 0."""
    global _STATE
    if isinstance(policy, str):
        policy = QuantPolicy(policy)
    if error_budget is None:
        error_budget = 0.02 if policy == QuantPolicy.ERROR_BUDGET else 0.0
    _STATE = PolicyState(policy, float(error_budget))
    return _STATE


def reset_quant_policy() -> None:
    """Back to ``TD_QUANT``."""
    global _STATE
    _STATE = None


def _state(state: PolicyState | None) -> PolicyState:
    return get_quant_policy() if state is None else state


def _admits(state: PolicyState, op: str, method: str, world: int) -> bool:
    """OFF never; ALWAYS always; ERROR_BUDGET when the (op, method)
    contract's bound at ``world`` fits the budget."""
    if state.policy == QuantPolicy.OFF:
        return False
    if state.policy == QuantPolicy.ERROR_BUDGET:
        from triton_dist_tpu_torch.quant.contract import contract_for
        return contract_for(op, method).rel_bound(world) <= \
            state.error_budget
    return True


def wire_eligible_methods(op: str, methods: Sequence[str]) -> list[str]:
    """The methods an automatic choice may pick from: "auto" and, for ops
    with lossy tiers, every lossy method value dropped, whatever the
    policy (the upgrade path is ``auto_wire_method`` alone)."""
    lossy = LOSSY_TIERS.get(op, frozenset())
    return [m for m in methods if m != "auto" and m not in lossy]


def is_lossy(op: str, method: str) -> bool:
    return method in LOSSY_TIERS.get(op, frozenset())


def auto_wire_method(op: str, quantized_method: str, *, world: int,
                     eligible: bool = True,
                     predicted_lossless_ms: float | None = None,
                     predicted_quantized_ms: float | None = None,
                     state: PolicyState | None = None) -> str | None:
    """Should an automatic choice upgrade this dispatch to
    ``quantized_method``? The method value to run, or None to keep the
    lossless one. ``eligible`` is the op's shape eligibility."""
    if not eligible or world <= 1:
        return None
    state = _state(state)
    if state.policy == QuantPolicy.OFF:
        return None
    if not is_lossy(op, quantized_method):
        raise ValueError(
            f"auto_wire_method asked about ({op!r}, {quantized_method!r}) "
            "which is not a registered lossy tier: register it in "
            "LOSSY_TIERS and give it a QuantContract first")
    if state.policy == QuantPolicy.ALWAYS:
        return quantized_method
    if not _admits(state, op, quantized_method, world):
        return None
    if (predicted_lossless_ms is not None
            and predicted_quantized_ms is not None
            and predicted_quantized_ms >= predicted_lossless_ms):
        return None
    return quantized_method


def lossy_fallback_ok(op: str, method: str, *,
                      policy_selected: bool) -> bool:
    """May a failure of this tier degrade to the lossless twin? Lossless
    tiers: yes. Lossy ones only when the policy selected them (an explicit
    ask gets its failures, not a silent change of numerics)."""
    if not is_lossy(op, method):
        return True
    return bool(policy_selected)


def serving_gemm_ar_method(world: int = 2,
                           state: PolicyState | None = None):
    """The method ``MegaDecodeRuntime`` hands the mega graph's
    linear_allreduce tasks when the caller left it unset: None (AUTO)
    under OFF; the int8 wire (GemmArMethod.XLA_QINT8) under ALWAYS, or
    under ERROR_BUDGET when the gemm_ar contract's bound at ``world``
    (never below the 2-rank floor) fits the budget."""
    if not _admits(_state(state), "gemm_ar", "xla_qint8",
                   max(int(world), 2)):
        return None
    from triton_dist_tpu_torch.kernels.gemm_allreduce import GemmArMethod
    return GemmArMethod.XLA_QINT8


def resolve_kv_page_codec(requested: str | None = None,
                          state: PolicyState | None = None) -> str | None:
    """The KV movers' page codec: an explicit name wins; with none, the
    policy (the kv_handoff contract judged at the 2-rank floor: it is
    transport only) gives "kv_int8_page" or None for full-width pages."""
    if requested is not None:
        return requested
    if not _admits(_state(state), "kv_handoff", "kv_int8_page", 2):
        return None
    return "kv_int8_page"


def resolve_kv_resident(requested: str | None = None,
                        state: PolicyState | None = None) -> str | None:
    """The resident pool codec: "int8" always wins, "off" always loses,
    "auto"/None asks the policy (the kv_resident contract at the 2-rank
    floor). Returns "kv_int8_row" or None for full-width pools."""
    if requested == "int8":
        return "kv_int8_row"
    if requested == "off":
        return None
    if requested not in (None, "auto"):
        raise ValueError(
            f"kv_resident={requested!r}: want 'auto' | 'int8' | 'off'")
    if not _admits(_state(state), "kv_resident", "kv_int8_row", 2):
        return None
    return "kv_int8_row"


def resolve_ep_payload_dtype(requested, state: PolicyState | None = None):
    """The expert-parallel dispatch payload's wire dtype: an explicit
    ``requested`` (EpA2AContext.payload_dtype) always wins; with none set,
    the policy (the ep_dispatch contract at the 2-rank floor) gives fp8
    e4m3 (torch.float8_e4m3fn: per-row quantized rows, their f32 scales
    beside them) or None for the full width."""
    if requested is not None:
        return requested
    if not _admits(_state(state), "ep_dispatch", "fp8_row", 2):
        return None
    import torch
    return torch.float8_e4m3fn
