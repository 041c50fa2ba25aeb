"""Runtime code parameters for convolutional codes.

Runtime replacement for the reference's compile-time macro configuration
(reference: src/defaultParams/convCodeParams.h:8-21, convCodeParams.c:1-6,
src/convEncode.h:8-18, src/viterbiDecoder.h:28-95).  Where the reference fixes
one code per binary via include-path swapping ("template by include",
viterbiDecoder.h:8-16), this framework makes the code a runtime value: a
`CodeSpec` is a small frozen dataclass that is hashable, so it can be a static
argument to `jax.jit` and every derived constant (trellis tables, butterfly
tables, dtype selection) is computed once per spec at trace time.

Conventions (identical to the reference):
  * Generators are given in Proakis big-endian order: the MSB of each k*K-bit
    generator corresponds to the *most recent* input bit
    (convCodeParams.c:4-5).  Internally they are bit-reversed so the LSb
    corresponds to the current input (convEncode.h:32-34, convEncode.c:163-175).
  * The encoder shift register ("tapped delay") shifts new bits into the LSb:
    ``delay' = (delay << 1) | bit`` (convEncode.c:93).  The state index is the
    low k*S bits of the delay, so bit ``i`` of a state is the input bit from
    ``i`` bit-shifts ago.
  * Bytes are consumed/emitted MSb-first (convEncode.h:50-66).
  * Packets are terminated by S all-zero input steps, which force the encoder
    back to state 0 (convEncode.c:108-119).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np


def bit_reverse(value: int, width: int) -> int:
    """Reverse the low `width` bits of `value`.

    Equivalent to the reference's bitReverseGenerator (convEncode.c:163-175).
    """
    out = 0
    for _ in range(width):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


@dataclass(frozen=True)
class CodeSpec:
    """A rate-k/n convolutional code definition.

    Attributes:
      K: constraint length (number of k-bit stages influencing the output,
         including the current input).  Reference: convCodeParams.h `K`.
      g: generator polynomials, one per output bit, in Proakis big-endian
         bit order over k*K bits (MSB = newest input).  len(g) == n.
      k: input bits shifted in per trellis step (reference `k`).
      starting_state: the state the shift register starts in (and the state
         the terminated packet ends in).  Only 0 is supported, matching
         viterbiConfigCheck (viterbiDecoder.c:10-13).
      traceback_len: survivor-path truncation depth for the streaming decoder.
         Reference: TRACEBACK_LEN = 5*K (viterbiDecoder.h:19).
    """

    K: int
    g: Tuple[int, ...]
    k: int = 1
    starting_state: int = 0
    traceback_len: int = 0  # 0 -> default 5*K, resolved in __post_init__

    def __post_init__(self):
        if self.K < 2:
            raise ValueError(f"K must be >= 2, got {self.K}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if not self.g:
            raise ValueError("need at least one generator polynomial")
        if self.k * self.K > 32:
            # The reference supports k*K <= 64 (convEncode.h:8-18); we keep
            # tables in int32, so cap at 32 taps for now.
            raise ValueError(f"k*K = {self.k * self.K} > 32 not supported")
        width = self.k * self.K
        for i, gi in enumerate(self.g):
            if gi <= 0 or gi >= (1 << width):
                raise ValueError(
                    f"g[{i}] = {gi:#o} does not fit in k*K = {width} bits"
                )
        if self.starting_state != 0:
            # Matches the reference's explicit restriction
            # (viterbiDecoder.c:10-13).
            raise ValueError("only starting_state == 0 is supported")
        if self.traceback_len == 0:
            object.__setattr__(self, "traceback_len", 5 * self.K)
        object.__setattr__(self, "g", tuple(int(gi) for gi in self.g))

    # ---- derived quantities (reference: convCodeParams.h:8-21) ----

    @property
    def n(self) -> int:
        """Coded bits emitted per trellis step."""
        return len(self.g)

    @property
    def S(self) -> int:
        """State stages: S = K - 1 (convCodeParams.h)."""
        return self.K - 1

    @property
    def rate(self) -> float:
        """Code rate Rc = k / n."""
        return self.k / self.n

    @property
    def num_states(self) -> int:
        """NUM_STATES = 2^(k*S) (viterbiDecoder.h:28)."""
        return 1 << (self.k * self.S)

    @property
    def num_edges_per_state(self) -> int:
        return 1 << self.k

    @property
    def delay_width(self) -> int:
        """Width of the tapped delay register in bits (convEncode.h:8-18)."""
        return self.k * self.K

    @property
    def g_reversed(self) -> Tuple[int, ...]:
        """Generators bit-reversed over k*K bits so the LSb taps the newest
        input bit (convEncode.c:13-17,163-175)."""
        return tuple(bit_reverse(gi, self.delay_width) for gi in self.g)

    @property
    def has_poly_symmetry(self) -> bool:
        """True iff every generator taps both the newest and the oldest bit.

        This is the validity condition for the butterfly decoder's
        single-edge-metric complement trick (USE_POLY_SYMMETRY,
        viterbiDecoder.h:33-39, checked at viterbiDecoder.c:15-27).  Only
        meaningful for k == 1.
        """
        if self.k != 1:
            return False
        return all(
            ((gi >> (self.K - 1)) & 1) and (gi & 1) for gi in self.g
        )

    @property
    def metric_dtype(self):
        """Path-metric dtype for the *unrenormalized* scan decoder.

        The reference sizes METRIC_TYPE from the worst-case accumulated
        metric (viterbiDecoder.h:43-62); we simply use int32, in the scan
        reference decoders and the decoder core alike.
        """
        return np.int32

    def validate_for_butterfly(self) -> None:
        """Raise if this spec cannot use the poly-symmetry butterfly decoder
        (reference: viterbiConfigCheck, viterbiDecoder.c:15-27)."""
        if self.k != 1:
            raise ValueError("butterfly decoder requires k == 1")
        if not self.has_poly_symmetry:
            raise ValueError(
                "generators must tap both the newest and oldest bit for the "
                "poly-symmetry butterfly decoder (viterbiDecoder.c:20-25)"
            )

    def coded_segments_for(self, message_bits: int, terminate: bool = True) -> int:
        """Number of n-bit coded segments produced for a message.

        Matches convEnc's accounting (convEncode.c:46-130): one segment per k
        message bits, plus S termination segments.
        """
        if message_bits % self.k != 0:
            raise ValueError(
                f"message length {message_bits} not a multiple of k={self.k}"
            )
        return message_bits // self.k + (self.S if terminate else 0)


# ---- presets ----

#: The NASA-standard K=7 (133,171) code used by the reference's MATLAB
#: oracles (scripts/matlab/viterbiBEREstimate.m:11, berCurveCoded.m:9) and
#: named in the reference comment berTestK7.c:90-91.
NASA_K7 = CodeSpec(K=7, g=(0o133, 0o171))

#: The code the reference C binary actually ships with: note g[0] = 0113, not
#: 0133 (src/defaultParams/convCodeParams.c:6) — a (presumably accidental)
#: discrepancy from the MATLAB oracles, documented in SURVEY.md §4.  Provided
#: for bit-exact comparison against the C binary.
REF_K7 = CodeSpec(K=7, g=(0o113, 0o171))

#: The K=3 toy code from the hand-traced unit test
#: (handTracedTest/testParams/convCodeParams.h:8-17, .c:6).
TOY_K3 = CodeSpec(K=3, g=(0b111, 0b110))

#: K=5 (23, 35) — a common small standard code, for coverage of other K.
K5_23_35 = CodeSpec(K=5, g=(0o23, 0o35))

#: K=9 (561, 753) — the CDMA / IS-95 forward-link code, exercises 256 states.
K9_561_753 = CodeSpec(K=9, g=(0o561, 0o753))

#: Rate-1/3 K=7 (133, 145, 175) — exercises n=3.
NASA_K7_R13 = CodeSpec(K=7, g=(0o133, 0o145, 0o175))

#: The LTE tail-biting convolutional code (36.212 §5.1.3.1): K=7 rate-1/3
#: (133, 171, 165), used with `ops.tailbiting` (no termination flush).
LTE_TBCC_K7 = CodeSpec(K=7, g=(0o133, 0o171, 0o165))


def replace(spec: CodeSpec, **kwargs) -> CodeSpec:
    """Functional update of a CodeSpec."""
    return dataclasses.replace(spec, **kwargs)
