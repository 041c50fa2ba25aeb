"""Published peaks of the chips, keyed by JAX's `device_kind`.

A device missing here is an error: a roofline share against a guessed
peak is no measurement.  Each peak is of one chip, at the card's full
power limit (700 W for the H100 SXM); a card set lower cannot hold its
top clock, so the power limit is printed beside every share.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "int32_ops_per_s": 64 * 132 * 1.98e9,
        "source": (
            "HBM: NVIDIA H100 Tensor Core GPU data sheet, SXM, 3.35 TB/s. "
            "int32: NVIDIA Hopper architecture white paper, 64 INT32 units "
            "per SM, times 132 SMs, times the 1.98 GHz boost clock "
            "= 16.73e12 int32 ops/s."),
    },
}


def peak(device_kind: str) -> dict:
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"add them with their source to {__file__}") from None


def least_seconds(ops: float, nbytes: float, device_kind: str,
                  chips: int = 1) -> tuple[float, str]:
    """The least time `chips` chips of this kind need for `ops` int32
    operations and `nbytes` of device-memory traffic, and which of the two
    bounds it ("int32" or "hbm")."""
    p = peak(device_kind)
    t_ops = ops / (p["int32_ops_per_s"] * chips)
    t_mem = nbytes / (p["hbm_bytes_per_s"] * chips)
    return (t_ops, "int32") if t_ops >= t_mem else (t_mem, "hbm")
