"""Quantized communication (the reference's quant/): wire codecs with
executable error bounds (codec.py), the per-tier QuantContract promises
(contract.py) and the process QuantPolicy that owns every lossy-tier gate
(policy.py). The int8 staging and one-shot kernels live with the other
kernels (kernels/quant_wire.py)."""

from triton_dist_tpu_torch.quant.codec import (  # noqa: F401
    CODECS, FP8_ROW, INT8_BLOCK, INT8_STOCHASTIC, KV_INT8_PAGE, KV_INT8_ROW,
    WireCodec,
)
from triton_dist_tpu_torch.quant.codec import codec as wire_codec  # noqa: F401
from triton_dist_tpu_torch.quant.contract import (  # noqa: F401
    QuantContract, contract_for, contracts, register_contract,
)
from triton_dist_tpu_torch.quant.policy import (  # noqa: F401
    LOSSY_TIERS, PolicyState, QuantPolicy, auto_wire_method,
    get_quant_policy, is_lossy, lossy_fallback_ok, reset_quant_policy,
    resolve_ep_payload_dtype, resolve_kv_page_codec, resolve_kv_resident,
    serving_gemm_ar_method, set_quant_policy, wire_eligible_methods,
)
