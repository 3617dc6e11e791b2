"""What the device is, for every printed result.

A time means nothing without the card it was taken on and the power limit
it ran under (a card set below its maximum lowers its clocks under load), so
every benchmark and smoke run prints both beside JAX's own view.
"""

from __future__ import annotations

import os
import subprocess

import jax


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the visible cards,
    one line per card. Raises if ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def describe() -> str:
    """One line: platform, device kind, device count, JAX version and the
    ``XLA_FLAGS`` the process started with."""
    devs = jax.devices()
    return (f"platform={devs[0].platform} kind={devs[0].device_kind} "
            f"count={len(devs)} jax={jax.__version__} "
            f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")


def require_accelerator() -> None:
    """Raise unless JAX's default backend is an accelerator — a measurement
    path that finds no card fails; it never falls back to the CPU."""
    backend = jax.default_backend()
    if backend == "cpu":
        raise SystemExit(f"no accelerator: JAX's default backend is "
                         f"{backend!r}")
