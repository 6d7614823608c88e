"""Operations and bytes that the force law needs, from the inputs' sizes.

They belong to the law, not to any kernel's instruction mix, so a kernel
that evaluates each pair once for both bodies still cannot read above its
roofline.

The softened law for one unordered pair (i, j), float32, an FMA counted as
two operations:

    d = x_j - x_i                      3 subtractions          3
    s = |d|^2 + eps^2                  3 FMAs                  6
    r = 1 / sqrt(s)                    one rsqrt               1
    w = r^3                            2 multiplications       2
    m_j w, m_i w                       2 multiplications       2
    a_i += (m_j w) d, a_j -= (m_i w) d 6 FMAs                 12
                                                    total     26
"""

from __future__ import annotations

OPS_PER_PAIR = 26


def direct_sum_ops(n: int, ranks: int = 1) -> float:
    """Operations of one force evaluation over n bodies, the rank's share of
    the N (N - 1) / 2 unordered pairs."""
    return OPS_PER_PAIR * n * (n - 1) / 2 / ranks


def direct_sum_bytes(n: int, ranks: int = 1) -> float:
    """Bytes of one force evaluation on a rank: every body's position and
    mass (float32 x, y, z, m) read once, the rank's n / ranks accelerations
    (float32 x, y, z) written once."""
    return 16 * n + 12 * n / ranks
