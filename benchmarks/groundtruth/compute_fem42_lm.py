"""One-time ground-truth spectrum for the fem3d-42 benchmark matrix
scipy/ARPACK eigsh(k=100, which="LM", tol=1e-7)
on the assembled elasticity stiffness — the reference's own cross-check
config (Julia/benchmark.jl:42).  Result is cached as .npz next to this
script; chip_smoke.py's phase C asserts against it."""
import os
import time

import numpy as np
import scipy.sparse.linalg as sla

from rbl.utils.fem import fem_elasticity_3d

t0 = time.time()
A = fem_elasticity_3d(42)
print(f"assembled n={A.shape[0]} nnz={A.nnz} in {time.time()-t0:.0f}s",
      flush=True)
t0 = time.time()
w = sla.eigsh(A, k=100, which="LM", tol=1e-7, maxiter=50000,
              return_eigenvectors=False)
el = time.time() - t0
print(f"eigsh done in {el:.0f}s", flush=True)
np.savez_compressed(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "fem42_lm_k100.npz"),
    eigenvalues=np.sort(w)[::-1], tol=1e-7, method="scipy.eigsh ARPACK",
    wall_seconds=el,
)
print("saved", flush=True)
