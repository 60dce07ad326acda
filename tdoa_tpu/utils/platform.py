"""Backend choice and the persistent compilation cache.

One explicit platform per process: ``cpu`` or ``gpu``. A GPU request
on a host whose default JAX backend is not a GPU raises instead of
carrying on on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import jax

PLATFORMS = ("cpu", "gpu")

# <repo>/.jax_cache: a fixed path inside the checkout (the path is part
# of the cache key, so a directory that moves never hits).
_REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def select_platform(want: str) -> str:
    """Pin the process to ``want`` (``"cpu"`` or ``"gpu"``) and return
    the platform it runs on. Call before any computation."""
    if want not in PLATFORMS:
        raise ValueError(
            f"platform must be one of {PLATFORMS}, got {want!r}"
        )
    if want == "cpu":
        try:
            jax.config.update("jax_platforms", "cpu")
        except RuntimeError:
            pass  # backend already initialized; checked below
    plat = jax.devices()[0].platform
    if plat != want:
        raise RuntimeError(
            f"platform '{want}' requested but the default JAX backend is "
            f"'{plat}'"
            + (". No GPU is visible to JAX; set TDOA_TPU_PLATFORM=cpu to "
               "run on the CPU." if want == "gpu" else "")
        )
    return plat


def compilation_cache_dir(platform: str) -> Optional[str]:
    """Where the persistent compilation cache lives for ``platform``:
    ``JAX_COMPILATION_CACHE_DIR`` when set, else ``<repo>/.jax_cache``
    on GPU runs, else None (CPU runs stay uncached: XLA:CPU entries
    embed the compiling host's CPU features, and reloading them on a
    different host risks SIGILL; CPU compiles are cheap anyway)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR", "")
    if env:
        return env
    return _REPO_CACHE if platform == "gpu" else None


def setup_compilation_cache(platform: str) -> Optional[str]:
    """Enable the persistent compilation cache for ``platform`` (see
    :func:`compilation_cache_dir`) and return its directory, or None."""
    where = compilation_cache_dir(platform)
    if where is None:
        return None
    os.makedirs(where, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", where)
    # Cache every compile: the programs are few, and even short
    # compiles add up across processes.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return where


def gpu_name_power_limit() -> Optional[str]:
    """The first card's name and power limit as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``), or None when
    nvidia-smi is missing or fails. A card set below its maximum power
    runs slower under load, so every timing is reported beside this."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [l.strip() for l in out.splitlines() if l.strip()]
    return lines[0] if lines else None
