"""Elastic shell stretching energies in JAX (balloon-sim application layer).

The reference vendors libshell with ~1.5 KLoC of hand-coded per-face
gradients/Hessians (06_example_balloon_sim/sim_utils/MaterialModel/*.cpp,
GeometryDerivatives.cpp).  Here we instead write the per-face energy
densities once and get exact derivatives from JAX autodiff: the gradient is
one reverse-mode pass over all faces, and the per-face 9x9 Hessians come
from a vmapped forward-over-reverse `jax.hessian` — both batched
device code.

Energy densities (exactly the reference's formulas, stretching term only —
the balloon sim uses ET_STRETCHING alone, implicit_euler_mg_balloon.h:53):

- StVK (StVKMaterial.cpp:21-31):
    W = t/4 * dA * (alpha/2 tr(S)^2 + beta tr(S^2)),
    S = abar^-1 (a - abar),  dA = 1/2 sqrt(det abar)
- NeoHookean (NeoHookeanMaterial.cpp:21-34):
    W = t sqrt(det abar)/4 * (beta (tr(abar^-1 a) - 2 - 2 lnJ) + alpha lnJ^2),
    lnJ = 1/2 ln(det a / det abar)
- Tension-field StVK (TensionFieldStVKMaterial.cpp:21-110): StVK in pure
  tension; zero when fully slack (lambda1 < 0); relaxed single-wrinkle
  energy k dA lambda1^2 otherwise.

Lame parameters from Young's modulus / Poisson ratio as in the reference
(main.cpp:63-67): alpha = Y nu / (1 - nu^2), beta = Y / (2 (1 + nu)).
"""

from __future__ import annotations

import functools

import numpy as np
import scipy.sparse as sp

import jax
import jax.numpy as jnp

MATERIALS = ("neohookean", "stvk", "tension_field")


def _highest(fn):
    """Trace `fn` with every matrix product at Precision.HIGHEST: an f32
    product at default precision may run in TF32 on a GPU (~3 decimal
    digits), too coarse for the Newton Hessians.  The precision is fixed
    when the product is traced, so it holds under jit, vmap and autodiff.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


def psd_project_blocks(H: jnp.ndarray, schedule=None) -> jnp.ndarray:
    """Per-face PSD projection of symmetric Hessian blocks [m, d, d]:
    clamp negative eigenvalues to (near) zero.

    Why: the raw autodiff shell Hessians (like the reference's hand-coded
    ones, sim_utils/ElasticShell.cpp — no projection there either) go
    INDEFINITE under large deformation (on bunny_15K at the reference's
    inflation pressure 1e6: min eig(H) = -2.8e-3 with a -0.63 diagonal
    entry).  The reference survives because its LDLT/Gauss-Seidel in f64
    limps through and the line search rejects the garbage directions; an
    SPD-assuming f32 multigrid (Chebyshev window, coarse Cholesky) instead
    diverges to overflow.  Clamping per-block is the standard Newton
    globalization for elastic shells.

    How: the matrix sign function by a Newton-Schulz-type cubic iteration
    (x <- a x - b x^3, ops/psd.py), and
        PSD(H) = (H + H sign(H)) / 2 = U max(L, 0) U^T.
    Eigenvalues tiny relative to ||H|| converge slowly through the sign
    iteration, but their clamping error is proportionally tiny
    (|residue| <= |lam|), so big negatives — the ones that break the
    solver — are removed exactly while near-null directions keep a
    harmless residue (the schedule saturates the sign for
    |lam|/||H|| >= ~1.2e-3; smaller negatives are dominated by dt^2
    scaling + the positive lumped mass).

    Blocks are packed `126 // d` at a time into block-diagonal 128x128
    tiles; block-diagonality is exact under products, so the extraction
    is exact.  Blocks whose clamp correction is below 1e-4 ||H|| pass
    through BITWISE unchanged, so trajectories at moderate loads are
    identical.
    """
    from ..ops.psd import NS_SCHEDULE, TILE, ns_sign_apply_packed

    if schedule is None:
        schedule = NS_SCHEDULE
    Hs = 0.5 * (H + jnp.swapaxes(H, -1, -2))
    m, d = H.shape[0], H.shape[-1]
    # per-block inf-norm >= spectral radius; scale into the schedule's
    # validity domain |x| <= 1.4
    s = jnp.abs(Hs).sum(axis=-1).max(axis=-1)
    s = jnp.maximum(s, 1e-30)
    X = Hs / s[:, None, None]

    pack = max(1, (TILE - 2) // d)
    g = -(-m // pack)
    Xpad = jnp.zeros((g * pack, d, d), dtype=H.dtype)
    Xpad = jax.lax.dynamic_update_slice(Xpad, X, (0, 0, 0))
    X4 = Xpad.reshape(g, pack, d, d)
    # Pack/extract via 0/1 selector matmuls: E[j, p, :] is the one-hot
    # row for packed position j*d+p, so Z = E^T X4 E places each block
    # at its diagonal offset and Yb = E Y E^T reads it back.  Selector
    # products at Precision.HIGHEST pick entries EXACTLY (bitwise equal
    # to dynamic slices).
    hi = jax.lax.Precision.HIGHEST
    E = jax.nn.one_hot(
        jnp.arange(pack)[:, None] * d + jnp.arange(d)[None, :], TILE,
        dtype=H.dtype,
    )
    T = jnp.einsum("gjpq,jqc->gjpc", X4, E, precision=hi)
    Z = jnp.einsum("jpr,gjpc->grc", E, T, precision=hi)

    Y = ns_sign_apply_packed(Z, schedule)
    # Y = X + X @ sign(X) packed; per-block Hp = s/2 * that block
    Tb = jnp.einsum("grc,jqc->gjrq", Y, E, precision=hi)
    Yb = jnp.einsum(
        "jpr,gjrq->gjpq", E, Tb, precision=hi
    ).reshape(g * pack, d, d)[:m].astype(H.dtype)
    Hp = 0.5 * s[:, None, None] * Yb
    Hp = 0.5 * (Hp + jnp.swapaxes(Hp, -1, -2))
    clamped = jnp.abs(Hp - Hs).max(axis=(-1, -2)) > 1e-4 * s
    return jnp.where(clamped[:, None, None], Hp, H)


def lame_parameters(young: float, poisson: float) -> tuple[float, float]:
    alpha = young * poisson / (1.0 - poisson * poisson)
    beta = young / 2.0 / (1.0 + poisson)
    return alpha, beta


@_highest
def first_fundamental_form(x9: jnp.ndarray) -> jnp.ndarray:
    """2x2 metric of one triangle given its stacked vertex positions [9]."""
    v0, v1, v2 = x9[0:3], x9[3:6], x9[6:9]
    e1, e2 = v1 - v0, v2 - v0
    return jnp.array(
        [
            [jnp.dot(e1, e1), jnp.dot(e1, e2)],
            [jnp.dot(e1, e2), jnp.dot(e2, e2)],
        ]
    )


def first_fundamental_forms(V: jnp.ndarray, F: jnp.ndarray) -> jnp.ndarray:
    """Per-face rest metrics abar [m,2,2] (ElasticShell::firstFundamentalForms)."""
    x9 = V[F].reshape(F.shape[0], 9)
    return jax.vmap(first_fundamental_form)(x9)


def _det2(a):
    return a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]


def _inv2(a):
    d = _det2(a)
    return jnp.array([[a[1, 1], -a[0, 1]], [-a[1, 0], a[0, 0]]]) / d


def _stvk_W(S, alpha, beta):
    return 0.5 * alpha * jnp.trace(S) ** 2 + beta * jnp.trace(S @ S)


@_highest
def metric_energy(c, abar, thickness, alpha, beta, material: str):
    """Stretching energy density as a function of the metric's three
    distinct entries c = (a11, a12, a22) — the ONLY channel through which
    the vertex positions enter every material law.  Shared by
    face_energy (value/grad paths) and the structured Hessian below."""
    a = jnp.array([[c[0], c[1]], [c[1], c[2]]])
    detabar = _det2(abar)
    abarinv = _inv2(abar)
    if material == "neohookean":
        deta = _det2(a)
        lnJ = 0.5 * jnp.log(deta / detabar)
        W = beta * (jnp.trace(abarinv @ a) - 2.0 - 2.0 * lnJ) + alpha * lnJ**2
        return thickness * jnp.sqrt(detabar) / 4.0 * W
    S = abarinv @ (a - abar)
    dA = 0.5 * jnp.sqrt(detabar)
    coeff = thickness / 4.0
    if material == "stvk":
        return coeff * dA * _stvk_W(S, alpha, beta)
    # tension-field StVK (branchless via jnp.where; the guarded sqrt keeps
    # autodiff NaN-free at branch boundaries)
    T = jnp.trace(S)
    D = _det2(S)
    disc = jnp.sqrt(jnp.maximum(T * T / 4.0 - D, 1e-30))
    lam1 = T / 2.0 + disc  # largest eigenvalue
    lam2 = T / 2.0 - disc
    k1 = 0.5 * coeff * alpha
    k2 = coeff * beta
    transition = -k1 / (k1 + k2)
    pure_tension = jnp.logical_and(lam1 >= 0, lam2 >= transition * lam1)
    slack = lam1 < 0
    # relaxed single-wrinkle energy: kstretching dA lambda1^2, with the
    # thickness/4 factor already inside k1/k2 (reference :103-106)
    kstretch = k1 + k2 - k1 * k1 / (k1 + k2)
    wrinkle = kstretch * dA * lam1 * lam1
    stvk = coeff * dA * _stvk_W(S, alpha, beta)
    return jnp.where(pure_tension, stvk, jnp.where(slack, 0.0, wrinkle))


@_highest
def _metric_entries(x9):
    e1, e2 = x9[3:6] - x9[0:3], x9[6:9] - x9[0:3]
    return e1, e2, jnp.array(
        [jnp.dot(e1, e1), jnp.dot(e1, e2), jnp.dot(e2, e2)]
    )


@_highest
def face_energy(x9, abar, thickness, alpha, beta, material: str):
    """Stretching energy of one face (density formulas above)."""
    _e1, _e2, c = _metric_entries(x9)
    return metric_energy(c, abar, thickness, alpha, beta, material)


# Constant edge maps e1 = L1 x9, e2 = L2 x9 and the (face-independent!)
# second derivatives of the metric entries: c is QUADRATIC in x9, so
# d2c1 = 2 L1'L1, d2c2 = L1'L2 + L2'L1, d2c3 = 2 L2'L2.
_L1 = np.hstack([-np.eye(3), np.eye(3), np.zeros((3, 3))])
_L2 = np.hstack([-np.eye(3), np.zeros((3, 3)), np.eye(3)])
_KC = np.stack([
    2.0 * _L1.T @ _L1,
    _L1.T @ _L2 + _L2.T @ _L1,
    2.0 * _L2.T @ _L2,
])  # [3, 9, 9]


@_highest
def face_hessian_stretch(x9, abar, thickness, alpha, beta, material: str):
    """Structured 9x9 stretching Hessian via the metric pullback.

    E(x9) = W(c(x9)) with c = (a11, a12, a22), so

        d2E = J' H_W J  +  sum_k (dW/dc_k) * d2c_k

    where J = dc/dx9 (3x9, linear in the edges) and the d2c_k are the
    constant tensors _KC above.  H_W is a 3-VARIABLE Hessian of the
    scalar material law — a handful of ops — replacing jax.hessian's
    nine JVP columns through the whole face-energy graph.
    Algebraically identical to jax.hessian(face_energy); validated to
    f64 roundoff in tests/test_shell.py."""
    e1, e2, c = _metric_entries(x9)

    def Wc(cc):
        return metric_energy(cc, abar, thickness, alpha, beta, material)

    gW = jax.grad(Wc)(c)
    HW = jax.hessian(Wc)(c)
    L1 = jnp.asarray(_L1, dtype=x9.dtype)
    L2 = jnp.asarray(_L2, dtype=x9.dtype)
    J = jnp.stack([
        2.0 * (L1.T @ e1),
        L1.T @ e2 + L2.T @ e1,
        2.0 * (L2.T @ e2),
    ])  # [3, 9]
    return J.T @ HW @ J + jnp.einsum(
        "k,kij->ij", gW, jnp.asarray(_KC, dtype=x9.dtype)
    )


def opposite_vertices(F: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For each face corner i: the vertex of the neighboring face across the
    edge opposite corner i (MeshConnectivity::vertexOppositeFaceEdge
    semantics).  Returns (opp [m,3] int64 with 0 placeholder, mask [m,3]
    1.0 where a neighbor exists)."""
    F = np.asarray(F, dtype=np.int64)
    m = F.shape[0]
    owner: dict[tuple[int, int], tuple[int, int]] = {}
    for f in range(m):
        for c in range(3):
            a, b = int(F[f, (c + 1) % 3]), int(F[f, (c + 2) % 3])
            owner[(a, b)] = (f, int(F[f, c]))
    opp = np.zeros((m, 3), dtype=np.int64)
    mask = np.zeros((m, 3))
    for f in range(m):
        for c in range(3):
            a, b = int(F[f, (c + 1) % 3]), int(F[f, (c + 2) % 3])
            got = owner.get((b, a))
            if got is not None:
                opp[f, c] = got[1]
                mask[f, c] = 1.0
    return opp, mask


def edge_tables(F: np.ndarray):
    """Per-face-corner edge ids and orientations + per-edge dihedral frame.

    edge i of face f joins F[f,(i+1)%3] -> F[f,(i+2)%3] (directed);
    the canonical frame of an undirected edge is taken from the first face
    in which it appears: (v0, v1, v2 = that face's opposite vertex,
    v3 = the other face's opposite vertex).  orient[f,i] = +1 for the
    canonical face, -1 for the other (MeshConnectivity::faceEdgeOrientation
    semantics feeding the alpha = theta/2 + orient*phi composition,
    MidedgeAngleTanFormulation.cpp:141)."""
    F = np.asarray(F, dtype=np.int64)
    m = F.shape[0]
    edges: dict[tuple[int, int], int] = {}
    ev = []  # v0, v1, v2, v3 (v3 = -1 until second face seen)
    eid = np.zeros((m, 3), dtype=np.int64)
    orient = np.zeros((m, 3))
    for f in range(m):
        for c in range(3):
            a, b = int(F[f, (c + 1) % 3]), int(F[f, (c + 2) % 3])
            key = (min(a, b), max(a, b))
            if key not in edges:
                edges[key] = len(ev)
                ev.append([a, b, int(F[f, c]), -1])
                eid[f, c] = edges[key]
                orient[f, c] = 1.0
            else:
                e = edges[key]
                ev[e][3] = int(F[f, c])
                eid[f, c] = e
                orient[f, c] = -1.0
    ev = np.asarray(ev, dtype=np.int64)
    return eid, orient, ev


def edge_thetas_jax(V: jnp.ndarray, ev: jnp.ndarray) -> jnp.ndarray:
    """Signed dihedral angle per edge (GeometryDerivatives edgeTheta/angle:
    theta = 2 atan2((n0 x n1).axis/|axis|, n0.n1 + |n0||n1|)); 0 on
    boundary edges (ev[:,3] < 0)."""
    q0, q1 = V[ev[:, 0]], V[ev[:, 1]]
    q2 = V[ev[:, 2]]
    q3 = V[jnp.maximum(ev[:, 3], 0)]
    n0 = jnp.cross(q0 - q2, q1 - q2)
    n1 = jnp.cross(q1 - q3, q0 - q3)
    axis = q1 - q0
    num = (jnp.cross(n0, n1) * axis).sum(-1) / jnp.linalg.norm(axis, axis=-1)
    den = (n0 * n1).sum(-1) + jnp.linalg.norm(n0, axis=-1) * jnp.linalg.norm(
        n1, axis=-1
    )
    theta = 2.0 * jnp.arctan2(num, den)
    return jnp.where(ev[:, 3] >= 0, theta, 0.0)


@_highest
def second_fundamental_form_angle(x9, theta3, phi3, orient3, variant: str):
    """Angle-based midedge SFF of one face
    (MidedgeAngle{Tan,Sin}Formulation.cpp:110-270):
    II_i = 2 h_i * tan_or_sin(theta_e/2 + orient*phi_e), h_i the altitude
    from corner i; b = [[II0+II1, II0],[II0, II0+II2]]."""
    q = x9.reshape(3, 3)
    n = jnp.cross(q[1] - q[0], q[2] - q[0])
    nnorm = jnp.linalg.norm(n)
    II = []
    for i in range(3):
        e = q[(i + 2) % 3] - q[(i + 1) % 3]
        h = nnorm / jnp.linalg.norm(e)
        alpha = 0.5 * theta3[i] + orient3[i] * phi3[i]
        g = jnp.tan(alpha) if variant == "tan" else jnp.sin(alpha)
        II.append(2.0 * h * g)
    return jnp.array([[II[0] + II[1], II[0]], [II[0], II[0] + II[2]]])


@_highest
def second_fundamental_form(x18, mask3):
    """Midedge-average SFF of one face from its 6-vertex stencil
    (reference MidedgeAverageFormulation.cpp:7-246): unnormalized own and
    neighbor face normals; II_i = (q_{i+1}+q_{i+2}-2q_i).n_opp,i /
    |n_opp,i + n_c|; b = [[II0+II1, II0],[II0, II0+II2]].

    x18 = [q0,q1,q2, o0,o1,o2] stacked; mask3 zeroes boundary edges."""
    q = x18[:9].reshape(3, 3)
    o = x18[9:].reshape(3, 3)
    cN = jnp.cross(q[1] - q[0], q[2] - q[0])
    II = []
    for i in range(3):
        b_v = q[(i + 1) % 3]
        c_v = q[(i + 2) % 3]
        # neighbor face (c_v, b_v, o_i) in CCW order; normal matches the
        # consistent orientation of the mesh
        oppN = mask3[i] * jnp.cross(b_v - c_v, o[i] - c_v)
        mvec = oppN + cN
        mnorm = jnp.sqrt((mvec * mvec).sum())
        qvec = b_v + c_v - 2.0 * q[i]
        II.append(jnp.dot(qvec, oppN) / mnorm)
    return jnp.array(
        [[II[0] + II[1], II[0]], [II[0], II[0] + II[2]]]
    )


@_highest
def face_bending_energy(x18, abar, bbar, mask3, thickness, alpha, beta,
                        material: str):
    """Bending energy of one face.

    StVK (StVKMaterial.cpp:62-108): t^3/12 * dA * W_StVK(abar^-1 (b-bbar));
    NeoHookean (NeoHookeanMaterial.cpp:70-117): sqrt(det abar) t^3/24 *
    W(adj(a) b / det a - adj(abar) bbar / det abar);
    tension-field: zero (TensionFieldStVKMaterial.cpp:174-189)."""
    if material == "tension_field":
        return jnp.asarray(0.0, dtype=x18.dtype)
    b = second_fundamental_form(x18, mask3)
    detabar = _det2(abar)
    if material == "neohookean":
        a = first_fundamental_form(x18[:9])
        deta = _det2(a)
        adj = lambda M: jnp.array(
            [[M[1, 1], -M[0, 1]], [-M[1, 0], M[0, 0]]]
        )
        S = adj(a) @ b / deta - adj(abar) @ bbar / detabar
        coeff = jnp.sqrt(detabar) * thickness**3 / 24.0
        return coeff * _stvk_W(S, alpha, beta)
    abarinv = _inv2(abar)
    S = abarinv @ (b - bbar)
    dA = 0.5 * jnp.sqrt(detabar)
    return thickness**3 / 12.0 * dA * _stvk_W(S, alpha, beta)


def _energy_sum(x_flat, F, abars, thickness, alpha, beta, material,
                bend=None):
    x9 = x_flat.reshape(-1, 3)[F].reshape(F.shape[0], 9)
    e = jax.vmap(
        lambda x, ab: face_energy(x, ab, thickness, alpha, beta, material)
    )(x9, abars)
    total = e.sum()
    if bend is not None:
        opp, mask, bbars = bend
        x18 = jnp.concatenate(
            [x9, x_flat.reshape(-1, 3)[opp].reshape(F.shape[0], 9)], axis=1
        )
        eb = jax.vmap(
            lambda x, ab, bb, mk: face_bending_energy(
                x, ab, bb, mk, thickness, alpha, beta, material
            )
        )(x18, abars, bbars, mask)
        total = total + eb.sum()
    return total


class ShellEnergy:
    """Stretching energy + autodiff gradient / per-face Hessians.

    Equivalent of ElasticShell<SFF>::elasticEnergy(..., ET_STRETCHING)
    returning (energy, gradient, Hessian triplets); the Hessian is
    assembled as a scipy CSR over interleaved xyz DOFs for the block
    multigrid solver.
    """

    def __init__(self, V_rest, F, thickness, alpha, beta,
                 material="neohookean", bending=False):
        assert material in MATERIALS
        self.F = np.asarray(F, dtype=np.int64)
        self.n = int(np.asarray(V_rest).shape[0])
        self.thickness = float(thickness)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.material = material
        self.bending = bool(bending)
        Fj = jnp.asarray(self.F)
        self.abars = first_fundamental_forms(jnp.asarray(V_rest), Fj)

        bend = None
        if self.bending:
            opp_np, mask_np = opposite_vertices(self.F)
            self.opp = opp_np
            self.mask = mask_np
            Vr = jnp.asarray(V_rest)
            x18_rest = jnp.concatenate(
                [
                    Vr[Fj].reshape(-1, 9),
                    Vr[jnp.asarray(opp_np)].reshape(-1, 9),
                ],
                axis=1,
            )
            self.bbars = jax.vmap(second_fundamental_form)(
                x18_rest, jnp.asarray(mask_np)
            )
            bend = (jnp.asarray(opp_np), jnp.asarray(mask_np), self.bbars)
        self._bend = bend

        fun = functools.partial(
            _energy_sum,
            F=Fj,
            abars=self.abars,
            thickness=self.thickness,
            alpha=self.alpha,
            beta=self.beta,
            material=self.material,
            bend=bend,
        )
        self._energy = jax.jit(fun)
        self._grad = jax.jit(jax.grad(fun))

        def face_h(x9, ab):
            return face_hessian_stretch(
                x9, ab, self.thickness, self.alpha, self.beta, self.material
            )

        self._face_hess = jax.jit(jax.vmap(face_h))

        # static COO pattern for Hessian assembly: rows/cols of each face's
        # 9x9 block over interleaved DOFs
        dof = (3 * self.F[:, :, None] + np.arange(3)[None, None, :]).reshape(-1, 9)
        self._rows = np.repeat(dof, 9, axis=1).reshape(-1)
        self._cols = np.tile(dof, (1, 9)).reshape(-1)

        if self.bending:
            def face_eb(x18, ab, bb, mk):
                return face_bending_energy(
                    x18, ab, bb, mk, self.thickness, self.alpha, self.beta,
                    self.material,
                )

            self._face_hess_bend = jax.jit(
                jax.vmap(jax.hessian(face_eb), in_axes=(0, 0, 0, 0))
            )
            vids = np.concatenate([self.F, self.opp], axis=1)  # [m, 6]
            dof18 = (
                3 * vids[:, :, None] + np.arange(3)[None, None, :]
            ).reshape(-1, 18)
            self._rows_b = np.repeat(dof18, 18, axis=1).reshape(-1)
            self._cols_b = np.tile(dof18, (1, 18)).reshape(-1)

    def energy(self, x_flat) -> float:
        return float(self._energy(jnp.asarray(x_flat)))

    def gradient(self, x_flat) -> np.ndarray:
        return np.asarray(self._grad(jnp.asarray(x_flat)), dtype=np.float64)

    def hessian(self, x_flat, psd_project: bool = False) -> sp.csr_matrix:
        """Assembled stiffness K; psd_project=True clamps each per-face
        block to PSD (see psd_project_blocks) — pass it when comparing
        against the multigrid steppers, which project by default."""
        x9 = np.asarray(x_flat, dtype=np.float64).reshape(-1, 3)[self.F].reshape(
            -1, 9
        )
        H = self._face_hess(jnp.asarray(x9), self.abars)
        if psd_project:
            H = psd_project_blocks(H)
        H = np.asarray(H)
        rows, cols, vals = self._rows, self._cols, H.reshape(-1)
        if self.bending:
            xv = np.asarray(x_flat, dtype=np.float64).reshape(-1, 3)
            x18 = np.concatenate(
                [xv[self.F].reshape(-1, 9), xv[self.opp].reshape(-1, 9)], axis=1
            )
            Hb = self._face_hess_bend(
                jnp.asarray(x18), self.abars, self.bbars,
                jnp.asarray(self.mask),
            )
            if psd_project:
                Hb = psd_project_blocks(Hb)
            Hb = np.asarray(Hb)
            rows = np.concatenate([rows, self._rows_b])
            cols = np.concatenate([cols, self._cols_b])
            vals = np.concatenate([vals, Hb.reshape(-1)])
        K = sp.coo_matrix(
            (vals, (rows, cols)), shape=(3 * self.n, 3 * self.n)
        ).tocsr()
        return K
