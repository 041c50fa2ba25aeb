"""Test/benchmark harnesses — the batched equivalents of the
reference's L4 executables (SURVEY.md §1): BER validation (berTestK7),
throughput benches (speedEncode/speedDecode)."""

from .ber import (
    BER_EXPECTED_K7,
    ber_point,
    ber_sweep,
    run_reference_ber_test,
)
from .bounds import bound_curve, distance_spectrum, union_bound_ber
from .curve import (TURBO_EXPECTED, run_bler_curve_tbcc,
                    run_bler_curve_turbo, run_curve, run_harq_ir_turbo,
                    run_turbo_acceptance)

__all__ = [
    "BER_EXPECTED_K7",
    "TURBO_EXPECTED",
    "ber_point",
    "ber_sweep",
    "bound_curve",
    "distance_spectrum",
    "run_reference_ber_test",
    "run_bler_curve_tbcc",
    "run_bler_curve_turbo",
    "run_curve",
    "run_harq_ir_turbo",
    "run_turbo_acceptance",
    "union_bound_ber",
]
