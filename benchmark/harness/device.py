"""Run-time set-up: the persistent compile cache, the chips a cell needs,
the card's identity, and the device memory peak.

Copied from the program's `utils/device.py` and changed in two places:
the cache is always the checkout's `.jax_cache`, and every compiled
program is kept there, however short its compile (JAX keeps only those
that took a second or more by default, which leaves out the Triton
decoder core and the small XLA programs around it).
"""

from __future__ import annotations

import os
import shutil
import subprocess

import jax

from .spec import ROOT


def setup_compile_cache(root: str = ROOT) -> str:
    """A fixed path inside the checkout, so that every run after the first
    finds its programs; call before the first compilation."""
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path


def require_chips(count: int) -> list:
    """The first `count` JAX devices, which must be GPUs: a measurement
    without the card is an error, never a CPU fallback."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU; JAX found {devs[0].platform!r} "
                         f"({devs[0].device_kind})")
    if len(devs) < count:
        raise SystemExit(f"the cell needs {count} GPUs; JAX found {len(devs)}")
    return devs[:count]


def gpu_identity() -> str:
    """`name, power.limit` of the first card, read by `nvidia-smi` in a
    child process that stays off JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi not found"
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def memory_peak_bytes(devices) -> int:
    """Peak bytes in use on the fullest of `devices` (0 where the backend
    keeps no statistics, as the CPU's does not)."""
    peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
             for d in devices]
    return int(max(peaks))
