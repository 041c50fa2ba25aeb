"""The work a Viterbi decode requires, from shapes alone.

It is the same whatever implements the decode, so it never changes when
the program does: no decision words, no halos, no padding, nothing a
particular split into kernels moves.

* Operations: add-compare-select, two adds, one compare and one select
  per state per trellis step.  The traceback's few operations per step
  are left out.
* Bytes: the received input read once, and the decoded message written
  once as packed bits.
"""

from __future__ import annotations


def acs_ops(steps: int, rows: int, K: int) -> int:
    """Int32 operations of the forward over `rows` packets of `steps`
    trellis steps of a constraint-length-K rate-1/n code."""
    return 4 * steps * rows * (1 << (K - 1))


def decode_bytes(input_bytes_per_row: int, rows: int,
                 message_bits: int) -> int:
    """Device-memory bytes the decode must move: input read, message
    written packed."""
    return rows * (input_bytes_per_row + -(-message_bits // 8))


def decode_work(steps: int, rows: int, K: int, input_bytes_per_row: int,
                message_bits: int) -> dict:
    return {"ops": acs_ops(steps, rows, K),
            "bytes": decode_bytes(input_bytes_per_row, rows, message_bits)}
