"""The device rso runs on.

`platform()` is the one place that checks the JAX backend: the step is
written and checked for a GPU and for the CPU (tests) only, and any other
platform raises rather than run untested code.  The measuring entry points
use `require_gpu()`: a measurement that finds no GPU fails and never falls
back to the CPU, so a CPU number is never reported as a device metric.
"""
from __future__ import annotations

import subprocess

SUPPORTED = ("gpu", "cpu")


def platform() -> str:
    """'gpu' or 'cpu': JAX's default backend; raises on any other."""
    import jax

    p = jax.default_backend()
    if p not in SUPPORTED:
        raise RuntimeError(f"rso supports the {' and '.join(SUPPORTED)} "
                           f"backends, not {p!r}")
    return p


def require_gpu():
    """Return jax.devices() if the default backend is a GPU, else raise."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: jax found {devs[0].platform!r} devices "
                         f"({devs[0].device_kind})")
    return devs


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for the first card, read by
    a child process that does not touch JAX or the card's memory."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def describe(devs) -> dict:
    """The device fields every result line carries."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
