"""Launch and fallback counters of the port's hand-written kernels.

Ported from ``spark_rapids_tpu/kernels/backend.py``.  The reference
chooses per call site between a Pallas kernel and its XLA composition
(``kernel.backend``).  The port routes by the tensor's device instead:
a CUDA tensor of a shape the kernel covers launches the kernel (or
raises), a CPU tensor takes the kernel's plain torch version.  The
``kernel.backend`` key is accepted and validated but not acted on.

What a call site could not hand to its kernel is a *fallback*, counted
with its reason exactly where the reference falls back to XLA (for
example a 2-D string payload in the segmented reduction).  Every kernel
launch is counted by name.  Both counters are plain ints, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

XLA = "xla"
PALLAS = "pallas"

# kernel name -> launches since the last reset_counts()
launches: Dict[str, int] = {}
# "family.reason" -> call sites that took the plain composition
fallbacks: Dict[str, int] = {}


def configure(conf) -> None:
    """Validate the reference's kernel-backend key (the port does not act
    on it)."""
    from spark_rapids_tpu_torch import config as cfg
    backend = str(conf.get(cfg.KERNEL_BACKEND) or PALLAS).strip().lower()
    if backend not in (XLA, PALLAS):
        raise ValueError(
            f"spark.rapids.tpu.kernel.backend must be 'xla' or "
            f"'pallas', got {backend!r}")


def record_launch(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def record_fallback(family: str, reason: str) -> None:
    key = f"{family}.{reason}"
    fallbacks[key] = fallbacks.get(key, 0) + 1


def reset_counts() -> None:
    launches.clear()
    fallbacks.clear()


def tpu_block(cap: int, base: int) -> int:
    """The element block the reference's TPU tile planner
    (``spark_rapids_tpu/kernels/tiling.py::_build``) gives a capacity:
    ``base`` grown in powers of two toward 128 blocks, at most 2^17
    elements.  Only the reference's gates read it; no CUDA kernel of the
    port is tiled by it."""
    def pow2_ceil(n: int) -> int:
        return 1 << max(int(n) - 1, 0).bit_length()
    b = min(pow2_ceil(cap), 1 << 17, max(base, pow2_ceil(max(cap // 128,
                                                               1))))
    if cap % b:
        b = min(cap, base)
    return b
