"""Published peaks of the cards the benchmark runs on.

NVIDIA's data sheet for the H100 SXM (dense rates, no sparsity), at its full
power limit of 700 W: a card set below it runs slower under load, so every
result names the card's power limit beside it (`clock.card`).
"""

from __future__ import annotations

H100_SXM = dict(
    fp32=67e12,  # FLOP/s, float32 outside the tensor cores
    fp64=34e12,  # FLOP/s, float64 outside the tensor cores
    tf32=495e12,  # FLOP/s, tensor cores
    bf16=989e12,  # FLOP/s, tensor cores
    hbm=3.35e12,  # bytes/s
    memory=80e9,  # bytes
)


def for_card(kind: str) -> dict | None:
    """The peaks of the card torch names `kind`, or None for another."""
    return H100_SXM if "H100" in kind else None
