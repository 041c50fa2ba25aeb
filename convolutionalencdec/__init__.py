"""convolutionalencdec — a batched FEC framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
ucb-cyarp/ConvolutionalEncDec: rate-k/n convolutional encoding and
hard/soft-decision Viterbi decoding, built for batched multi-channel
throughput on an NVIDIA GPU (the Viterbi core in `kernels.core`), with
multi-device scaling via jax.sharding.
"""

from .params import (
    CodeSpec,
    K5_23_35,
    K9_561_753,
    LTE_TBCC_K7,
    NASA_K7,
    NASA_K7_R13,
    REF_K7,
    TOY_K3,
)
from .ops.encode import encode_bits, encode_bytes
from .ops.viterbi import (
    viterbi_decode_bytes,
    viterbi_decode,
    viterbi_decode_ragged,
    viterbi_decode_stream,
    viterbi_decode_stream_soft,
    viterbi_forward,
    viterbi_forward_butterfly,
    traceback_terminated,
)
from .ops.metrics import (
    quantize_llrs,
    viterbi_decode_ragged_soft,
    viterbi_decode_soft,
)
from .ops.maxlogmap import (
    maxlogmap_decode,
    maxlogmap_llrs,
    maxlogmap_llrs_batch,
)
from .ops.tailbiting import (
    encode_tailbiting,
    viterbi_decode_tailbiting,
    viterbi_decode_tailbiting_exact,
    viterbi_decode_tailbiting_list,
    viterbi_decode_tailbiting_list_soft,
    viterbi_decode_tailbiting_soft,
)
from .ops.crc import (
    CrcSpec,
    CRC6_NR,
    CRC8_LTE,
    CRC11_NR,
    CRC16_CCITT,
    CRC24A,
    CRC24B,
    crc_append,
    crc_bits,
    crc_check,
)
from .ops.ratematch import (
    derate_match,
    rate_match,
    rate_match_segments,
)
from .ops.turbo import (
    RscSpec,
    qpp_interleaver,
    rsc_encode_batch,
    turbo_decode,
    turbo_decode_batch,
    turbo_encode_batch,
    turbo_encode_np,
)
from .ops.lte import (
    LTE_BLOCK_SIZES,
    lte_turbo_decode,
    lte_turbo_encode,
    lte_turbo_encode_batch,
    segment_tb,
    desegment_tb,
)
from .ops import (channel, crc, lte, maxlogmap, metrics, puncture, ratematch,
                  streaming, tailbiting, turbo)

# Subpackages imported lazily by most callers; exposed for discoverability.
from . import kernels, parallel, harness

__version__ = "0.1.0"

__all__ = [
    "CodeSpec",
    "NASA_K7",
    "NASA_K7_R13",
    "REF_K7",
    "TOY_K3",
    "K5_23_35",
    "K9_561_753",
    "LTE_TBCC_K7",
    "encode_bits",
    "encode_bytes",
    "viterbi_decode_bytes",
    "viterbi_decode",
    "viterbi_decode_ragged",
    "viterbi_decode_ragged_soft",
    "viterbi_decode_stream",
    "viterbi_decode_stream_soft",
    "viterbi_forward",
    "viterbi_forward_butterfly",
    "traceback_terminated",
    "viterbi_decode_soft",
    "quantize_llrs",
    "maxlogmap_llrs",
    "maxlogmap_llrs_batch",
    "maxlogmap_decode",
    "encode_tailbiting",
    "viterbi_decode_tailbiting",
    "viterbi_decode_tailbiting_exact",
    "viterbi_decode_tailbiting_list",
    "viterbi_decode_tailbiting_list_soft",
    "viterbi_decode_tailbiting_soft",
    "CrcSpec",
    "CRC6_NR",
    "CRC8_LTE",
    "CRC11_NR",
    "CRC16_CCITT",
    "CRC24A",
    "CRC24B",
    "crc",
    "crc_append",
    "crc_bits",
    "crc_check",
    "tailbiting",
    "channel",
    "metrics",
    "puncture",
    "ratematch",
    "rate_match",
    "rate_match_segments",
    "derate_match",
    "turbo",
    "RscSpec",
    "qpp_interleaver",
    "turbo_encode_np",
    "turbo_encode_batch",
    "rsc_encode_batch",
    "turbo_decode",
    "turbo_decode_batch",
    "lte",
    "LTE_BLOCK_SIZES",
    "lte_turbo_encode",
    "lte_turbo_encode_batch",
    "lte_turbo_decode",
    "segment_tb",
    "desegment_tb",
    "kernels",
    "parallel",
    "harness",
]
