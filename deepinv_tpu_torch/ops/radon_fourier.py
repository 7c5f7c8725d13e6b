"""FFT grid sizes (port of deepinv_tpu/ops/radon_fourier.py): only
:func:`_next_smooth` (:34), which sizes the Toeplitz embedding of the NUFFT
normal operator. The shear projector ``radon_fourier``/``iradon_fourier``
waits for ROADMAP queue 1 item 8.
"""

from __future__ import annotations

__all__: list[str] = []


def _next_smooth(n: int) -> int:
    """Smallest even 5-smooth integer >= n (radon_fourier.py:34)."""
    best = None
    a = 1
    while a <= 4 * n:
        b = a
        while b <= 4 * n:
            c = b
            while c <= 4 * n:
                if c >= n and c % 2 == 0 and (best is None or c < best):
                    best = c
                c *= 5
            b *= 3
        a *= 2
    return best if best is not None else n
