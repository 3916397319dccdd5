"""True multi-PROCESS fake-cluster test (SURVEY §4): two OS processes, each
with 4 virtual CPU devices, joined via ``jax.distributed`` into one 8-device
row mesh — the CPU analogue of one JAX process per GPU host.  The
single-process 8-device tests (test_distributed.py) cannot exercise the
cross-process collective path or the global-array programming model; this
one does, end-to-end through ``rbl``.

The reference has no distributed execution at all (SURVEY §2c)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_fake_cluster_solve():
    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "fake_cluster_worker.py")
    port = _free_port()
    env = {
        k: v for k, v in os.environ.items()
        if k != "XLA_FLAGS"
    }
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(rank), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True,
        )
        for rank in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    assert {o["rank"] for o in outs} == {0, 1}
    w0, w1 = (np.asarray(o["eigenvalues"]) for o in outs)
    # replicated host state must be IDENTICAL across ranks (same control
    # flow, same collectives) …
    np.testing.assert_array_equal(w0, w1)
    # … and correct: top-k of the analytic 2D Dirichlet Laplacian spectrum
    nx = 32
    ev1 = 2 - 2 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = np.sort(np.add.outer(ev1, ev1).ravel())[::-1][: len(w0)]
    np.testing.assert_allclose(w0, lam, rtol=1e-9)
    # general-sparse path (cross-process COO shard construction): identical
    # across ranks and correct vs the dense spectrum the workers solved
    import scipy.sparse as sp

    c0, c1 = (np.asarray(o["coo_eigenvalues"]) for o in outs)
    np.testing.assert_array_equal(c0, c1)
    rng = np.random.default_rng(7)
    M = sp.random(256, 256, density=0.03, random_state=rng)
    A = (M + M.T).toarray()
    w = np.linalg.eigvalsh(A)
    ref = w[np.argsort(-np.abs(w))][: len(c0)]
    np.testing.assert_allclose(c0, ref, rtol=1e-9)
