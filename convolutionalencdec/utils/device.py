"""Run-time set-up shared by the measurement scripts (`bench.py`,
`chip_smoke.py`): the persistent compile cache, the GPU requirement, and
the card's identity as `nvidia-smi` reports it."""

from __future__ import annotations

import os
import shutil
import subprocess

import jax

#: The checkout's root (the directory that holds the package).
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache() -> str:
    """Persistent compile cache: `JAX_COMPILATION_CACHE_DIR` when set
    (JAX reads it itself and nothing else is set here), otherwise
    `<checkout>/.jax_cache`, a fixed path so that runs can hit it.
    Call before the first compilation.  Returns the directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement without
    the card is an error, never a CPU fallback."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs an NVIDIA GPU; JAX found {dev.platform!r} "
                         f"({dev.device_kind})")
    return dev


def gpu_identity() -> str:
    """`name, power.limit` of the first card, read by `nvidia-smi` in a
    child process that stays off JAX."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise SystemExit("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]
