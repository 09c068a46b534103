"""Newton-Schulz matrix-sign products for the per-face PSD projection.

The balloon stepper projects every per-face 9x9 (or 18x18 bending) shell
Hessian block to PSD each Newton iteration (models/shell.psd_project_blocks;
the reference has no analog — its f64 LDLT limps through indefiniteness,
sim_utils/implicit_euler_mg_balloon.h:48-120, while an f32 SPD multigrid
needs the projection).  Blocks are packed into block-diagonal 128x128
tiles and the sign function runs as a fixed cubic schedule of products.

The accelerated coefficient schedule: 7 greedy growth cubics (max-slope
subject to p >= 0 on the tracked interval and max p <= 1.2) + 5 plain NS
cleanup cubics — 12 cubics (25 products incl. the final H·sign(H)) with
|sign - 1| <= 1e-4 for |lam|/s >= 7.9e-4.

Products run at Precision.HIGHEST (IEEE f32).  This is NOT optional: the
schedule was designed under exact-f32 scalar math, and at reduced input
precision (bf16, or TF32 on a GPU) the greedy growth phase — per-step
slopes up to ~2.6, seven steps — amplifies the input rounding on
small-eigenvalue directions into order-one spectral error.  Plain 16x NS
tolerates it only because its map contracts at the +-1 attractor
(p'(+-1) = 0); an accelerated schedule holds eigenvalues in the expanding
region for its whole growth phase.

The products are batched einsums left to XLA.  A hand-written Triton
kernel holding one tile per program through the whole schedule was tried
on the H100 and lost (PERF.md): XLA's form is the one kept.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# (a, b) per cubic step x <- a*x - b*x^3.  Valid (p >= 0, bounded by 1.2)
# on |x| <= 1.4; saturates |sign - 1| <= 5e-9 for |x| >= 1.5e-3 (7 greedy
# growth steps + 5 plain-NS quadratic cleanup steps).
NS_SCHEDULE = (
    (2.224875, 1.133054),
    (2.592197, 1.792000),
    (2.587663, 1.782611),
    (2.571791, 1.750010),
    (2.533244, 1.672496),
    (2.435745, 1.486720),
    (2.213538, 1.115821),
    (1.5, 0.5),
    (1.5, 0.5),
    (1.5, 0.5),
    (1.5, 0.5),
    (1.5, 0.5),
)

TILE = 128  # packed block-diagonal tile edge
HIGHEST = jax.lax.Precision.HIGHEST


def ns_sign_apply_packed(Xp: jnp.ndarray,
                             schedule=NS_SCHEDULE) -> jnp.ndarray:
    """[g, 128, 128] packed block-diagonal X (||X||_2 <= 1.4 per block,
    zero padding) -> X + X @ sign(X), as batched einsums at
    Precision.HIGHEST.  Block-diagonality is preserved exactly
    (off-diagonal zeros stay zero under products), so callers can slice
    the per-block results back out."""

    def mm(a, b):
        return jnp.einsum("fij,fjk->fik", a, b, precision=HIGHEST)

    Z = Xp
    for a, b in schedule:
        Z = a * Z - b * mm(mm(Z, Z), Z)
    return Xp + mm(Xp, Z)
