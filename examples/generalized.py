"""Generalized eigenproblem demo — FEM vibration + buckling, end to end.

Beyond the reference (standard-form only; SURVEY.md scope note): two
classic structural pencils solved with the factorization-free transforms
of rbl.solver.generalized, cross-checked against dense LAPACK.

1. Vibration modes: K·x = λ·M·x for a 1-D bar (stiffness K, consistent
   mass M — both tridiagonal).  Continuum eigenvalues are (kπ)²; we
   compute the lowest modes (which="SA") and a cluster near a target
   frequency (sigma=..., mode 3).
2. Buckling: K·x = λ·K_G·x with an indefinite geometric stiffness K_G
   (mode 4, B = K inner product, A-orthonormal vectors).

Usage: python examples/generalized.py [--n 2000] [--k 6]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import scipy.linalg
import scipy.sparse as sp


def fem_bar(n):
    """1-D bar on (0,1): stiffness + consistent mass (both tridiag)."""
    h = 1.0 / (n + 1)
    K = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)).tocsr() / h
    M = sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(n, n)).tocsr() * (h / 6)
    return K, M


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--k", type=int, default=6)
    args = ap.parse_args()

    import rbl as rt

    n, k = args.n, args.k
    K, M = fem_bar(n)

    print(f"== vibration: lowest {k} modes of K·x = λ·M·x (n={n}) ==")
    # Lowest modes of a stiff pencil (λ spans 9.87 … ~4n²) are an INTERIOR
    # problem in disguise: exterior which="SA" shifts by ‖S‖ and compresses
    # the bottom gaps by ~1/κ.  Shift-invert at σ = 0 (ν = 1/λ, which="LA"
    # → nearest above 0) converges in a handful of outer iterations.
    t0 = time.perf_counter()
    res = rt.rbl_generalized(K, M, k, which="LA", sigma=0.0,
                             cfg=rt.RBLConfig(block_size=k, tol=1e-9))
    el = time.perf_counter() - t0
    cont = (np.arange(1, k + 1) * np.pi) ** 2
    print(f"  eigenvalues: {np.array2string(res.eigenvalues, precision=4)}")
    print(f"  continuum (kπ)²: {np.array2string(cont, precision=4)}")
    print(f"  converged={res.converged}  {el:.2f}s")

    sig = float(res.eigenvalues[-1] * 4.0)
    print(f"== vibration: {k} modes nearest σ={sig:.1f} (mode 3) ==")
    t0 = time.perf_counter()
    resi = rt.rbl_generalized(K, M, k, which="LM", sigma=sig,
                              cfg=rt.RBLConfig(block_size=k, tol=1e-8))
    el = time.perf_counter() - t0
    print(f"  eigenvalues: {np.array2string(resi.eigenvalues, precision=4)}")
    print(f"  converged={resi.converged}  {el:.2f}s")

    # Buckling pencil on a smaller problem so the dense cross-check is
    # cheap.  NB: buckling takes B = K roots, so K should be reasonably
    # conditioned for the auto-fitted Chebyshev K^{±1/2} (a κ ~ n² FEM
    # stiffness needs explicit m_bounds/degree — see rbl_generalized docs);
    # this demo uses a mass-scaled stiffness with κ ~ 10.
    nb = min(n, 400)
    rng = np.random.default_rng(0)
    Kb = sp.diags([-np.ones(nb - 1), rng.uniform(4.0, 9.0, nb),
                   -np.ones(nb - 1)], [-1, 0, 1]).tocsr()
    KG = sp.diags(np.where(np.arange(nb) % 2 == 0, 1.0, -1.0)) \
        + 0.2 * sp.diags([np.ones(nb - 1), np.ones(nb - 1)], [-1, 1])
    KG = sp.csr_matrix(KG)
    sigb = 9.7
    print(f"== buckling: K·x = λ·K_G·x, {3} modes nearest σ={sigb} "
          f"(mode 4, n={nb}) ==")
    t0 = time.perf_counter()
    resb = rt.rbl_generalized(Kb, KG, 3, which="LM", sigma=sigb,
                              mode="buckling",
                              cfg=rt.RBLConfig(block_size=3, tol=1e-8))
    el = time.perf_counter() - t0
    w = np.sort(np.real(scipy.linalg.eig(
        Kb.toarray(), KG.toarray(), right=False)))
    nu = w / (w - sigb)
    dense = w[np.argsort(-np.abs(nu))[:3]]
    print(f"  eigenvalues:  {np.array2string(resb.eigenvalues, precision=6)}")
    print(f"  dense oracle: {np.array2string(dense, precision=6)}")
    print(f"  converged={resb.converged}  {el:.2f}s")

    # 3-D elasticity vibration with the assembled-matrix AMG tier
    # (ops/amg.py): the production-class path for SuiteSparse-like FEM
    # stiffness pencils — the grid-AMG inner preconditioner cuts the
    # inner MINRES from hundreds of iterations (scalar Jacobi) to ~25.
    import jax.numpy as jnp

    from rbl.utils.fem import fem_elasticity_3d

    N = 8
    A3 = fem_elasticity_3d(N)
    mlump = np.asarray(A3.sum(axis=1)).ravel()
    mlump = np.abs(mlump) + 1e-3 * np.abs(mlump).mean()
    amg = rt.AssembledMultigrid.from_grid(A3, (N, N + 1, N + 1), dof=3)
    print(f"== 3-D elasticity vibration: lowest 4 modes, grid-AMG "
          f"(n={A3.shape[0]}) ==")
    t0 = time.perf_counter()
    w3, V3 = rt.eigsh(
        A3, k=4, M=rt.DiagonalOperator(jnp.asarray(mlump, jnp.float64)),
        sigma=0.0, which="LM", tol=1e-8, inner_psolve=amg.psolve,
    )
    el = time.perf_counter() - t0
    R3 = A3 @ V3 - (mlump[:, None] * V3) * w3[None, :]
    print(f"  eigenvalues: {np.array2string(w3, precision=6)}")
    print(f"  max residual: {np.linalg.norm(R3, axis=0).max():.2e}  "
          f"{el:.2f}s")


if __name__ == "__main__":
    main()
