"""QuantContract: the executable error promise of every quantized wire tier
(the reference's quant/contract.py).

A quantized tier ships only with a promise: how far its answer may be from
the exact (f32) result, as a function of the inputs and the world size.
``budget(inputs)`` returns that elementwise absolute budget, ``check``
asserts it, and the policy (quant/policy.py) reads the same numbers, so
what the chooser admits and what the tests hold can never drift.

Error model (worst case):

  * one quantization EVENT of codec c on a block with scale s moves an
    element by at most ``c.err_bound(x, s)``;
  * the one-shot tiers (B28, the EP fp8 payload) quantize each
    contribution exactly once: the budget is the sum of the per-term
    bounds;
  * the ring tiers (QINT8, gemm_ar XLA_QINT8) also requantize the running
    partial once per reduce-scatter hop and once for the all-gather:
    extra events whose scales are bounded by the sum of the terms'
    amaxes.

``rel_bound(world)`` is the scalar headline: the worst-case error
relative to the sum of the per-block amaxes.

The two evidence helpers of the reference (one contract-checked wave read
off the wire-byte counters, for the all-reduce and the KV packet) wait
for the mesh-level ``all_reduce_op`` (ROADMAP A9 (tail)), the wire
counters (A8) and the disaggregated packet serializer (A14).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from triton_dist_tpu_torch.quant.codec import WireCodec, codec as _codec


def _amax_rows(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs().amax(dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class QuantContract:
    """One (op, method)'s error promise: ``events(world)`` quantization
    events along one element's path from the inputs to the output."""
    op: str
    method: str
    codec_name: str
    events: Callable[[int], int]
    description: str = ""

    @property
    def codec(self) -> WireCodec:
        return _codec(self.codec_name)

    def rel_bound(self, world: int) -> float:
        """Worst-case output error relative to the summed block amaxes of
        the inputs."""
        return self.events(world) * self.codec.worst_rel_err

    def budget(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elementwise absolute error budget for reducing ``inputs`` (one
        tensor per rank; one tensor for a transport-only tier)."""
        c = self.codec
        shape = inputs[0].shape
        base = sum(torch.broadcast_to(c.err_bound(x, c.scale_of(x)),
                                      shape).float() for x in inputs)
        extra = self.events(len(inputs)) - len(inputs)
        if extra > 0:
            # only the int8 ring contracts declare extra events; their
            # bound is scale-only, so the summed-amax scale is all of it
            assert c.name.startswith("int8"), self.codec_name
            amax_sum = sum(_amax_rows(x) for x in inputs)
            scale_sum = torch.where(amax_sum == 0, 1.0, amax_sum / 127.0)
            base = base + extra * torch.broadcast_to(
                c.err_bound(inputs[0], scale_sum), shape).float()
        return base

    def check(self, exact: torch.Tensor, approx: torch.Tensor,
              inputs: Sequence[torch.Tensor], slack: float = 1.0) -> None:
        """Raise AssertionError where |approx - exact| exceeds the budget
        (slack > 1 loosens for float re-association noise)."""
        err = (approx.float() - exact.float()).abs()
        budget = self.budget(inputs).to(err.device) * slack + 1e-7
        worst = float((err - budget).max())
        if worst > 0.0:
            raise AssertionError(
                f"{self.op}/{self.method}: error exceeds the contract "
                f"budget by {worst:.3e} (codec {self.codec_name}, "
                f"events={self.events(len(inputs))})")


_CONTRACTS: dict[tuple[str, str], QuantContract] = {}


def register_contract(c: QuantContract) -> QuantContract:
    key = (c.op, c.method)
    if key in _CONTRACTS:
        raise ValueError(f"contract for {key} registered twice")
    _CONTRACTS[key] = c
    return c


def contract_for(op: str, method: str) -> QuantContract:
    try:
        return _CONTRACTS[(op, method)]
    except KeyError:
        raise KeyError(
            f"no QuantContract registered for ({op!r}, {method!r}): a "
            "quantized tier without an error promise must not ship") from None


def contracts() -> dict[tuple[str, str], QuantContract]:
    return dict(_CONTRACTS)


# the int8 ring all-reduce (QINT8): n per-term quantizations in the
# reduce-scatter, n - 1 partial requantizations and one for the all-gather
register_contract(QuantContract(
    "allreduce", "qint8", "int8_block", events=lambda n: 2 * n,
    description="ring RS requantizes the partial per hop; AG quantizes the "
                "reduced chunk once (the same bytes on all ranks)"))

# the one-shot int8 push kernel (B28): every contribution quantized once,
# reduced in f32
register_contract(QuantContract(
    "allreduce", "qint8_os", "int8_block", events=lambda n: n,
    description="one-shot: each term quantized once at the sender; one "
                "fold order makes all ranks' bytes the same"))

# GEMM + AR on the int8 wire (XLA_QINT8): the f32 partials ride the ring
register_contract(QuantContract(
    "gemm_ar", "xla_qint8", "int8_block", events=lambda n: 2 * n,
    description="local dot in f32, then the allreduce/qint8 ring"))

# the expert-parallel dispatch's fp8 payload (B18): one quantize at the
# sender, one dequantize at the receiver
register_contract(QuantContract(
    "ep_dispatch", "fp8_row", "fp8_row", events=lambda n: 1,
    description="per-row fp8 payload + f32 scales; combine returns "
                "full-width expert outputs (dispatch only)"))

# the low-latency all-to-all's quantized form used alone
register_contract(QuantContract(
    "fast_a2a_q", "fp8_row", "fp8_row", events=lambda n: 1,
    description="fused rows + scales exchange; one round trip per element"))

# int8 KV pages on the handoff wire: one encode at the exporter, one
# decode at the installer, whatever the world
register_contract(QuantContract(
    "kv_handoff", "kv_int8_page", "kv_int8_page", events=lambda n: 1,
    description="per-page int8 payload + f32 page scales; one encode -> "
                "decode round trip per element on the exporter -> "
                "installer path"))

# int8-resident KV pools: a row quantized once, at slot write; every
# later reader re-reads those bytes
register_contract(QuantContract(
    "kv_resident", "kv_int8_row", codec_name="kv_int8_row",
    events=lambda n: 1,
    description="per-row int8 pages + f32 row scales resident on the "
                "card; one encode at slot write"))

# the same codec on the KV wire: resident bytes re-wrapped, still one
# event in all
register_contract(QuantContract(
    "kv_handoff", "kv_int8_row", codec_name="kv_int8_row",
    events=lambda n: 1,
    description="resident kv_int8_row pages re-wrapped onto the handoff "
                "wire: the one event is the original slot write"))

# the dithered one-shot variant: one event per term at 1/127
register_contract(QuantContract(
    "allreduce", "qint8_os_stochastic", "int8_stochastic",
    events=lambda n: n,
    description="dither-rounded one-shot: at most one full step per event, "
                "deterministic bytes (fixed-key dither)"))
