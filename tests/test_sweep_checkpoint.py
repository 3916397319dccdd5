"""Mid-sweep checkpoint/resume + deterministic fault injection.

SURVEY §5: the reference has no checkpointing and no failure machinery.
Beyond the restart-boundary checkpoints (tests in test_restarted.py), the
MAIN solver can now persist its between-chunks state and resume after a
crash — these tests inject a deterministic preemption (SweepAborted) and
require the resumed solve to reproduce the uninterrupted answer.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sp

import rbl as rt
from rbl.config import RBLConfig


def _slow_diag(n):
    return sp.diags(np.arange(1.0, n + 1.0)).tocsr()


BASE = dict(
    block_size=5, eig_poll_cadence=4, chunk_growth_cap=1, pipeline_depth=1,
    max_kryl_dim=280, tol=1e-9,
)


class TestSweepCheckpoint:
    def test_abort_resume_matches_clean_run(self, tmp_path):
        n, k = 300, 5
        A = _slow_diag(n)
        ref = rt.rbl(A, k, cfg=RBLConfig(**BASE))
        assert ref.converged

        ck = str(tmp_path / "sweep.npz")
        cfg = RBLConfig(**BASE, sweep_checkpoint_path=ck,
                        fault_inject_abort_after_chunks=3)
        with pytest.raises(rt.SweepAborted):
            rt.rbl(A, k, cfg=cfg)
        assert os.path.exists(ck)
        z = np.load(ck)
        assert int(z["i"]) > 1  # real mid-sweep progress was saved
        saved_i = int(z["i"])

        # prove the resume CONTINUES rather than restarts: abort again one
        # chunk later — the new checkpoint must sit beyond the first one
        # (chunks_done resumes from 3, so the next processed chunk trips
        # an abort_after=4 injection immediately after saving)
        with pytest.raises(rt.SweepAborted):
            rt.rbl(A, k, cfg=cfg.replace(
                fault_inject_abort_after_chunks=4))
        assert int(np.load(ck)["i"]) > saved_i

        res = rt.rbl(A, k, cfg=cfg.replace(
            fault_inject_abort_after_chunks=None))
        assert res.converged
        np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                                   rtol=1e-10)
        V = res.eigenvectors
        R = A @ V - V * res.eigenvalues[None, :]
        assert np.max(np.linalg.norm(R, axis=0)) < 1e-6
        # completed solve removes its checkpoint (no stale resume later)
        assert not os.path.exists(ck)
        # and the resumed sweep really continued past the saved iteration
        assert res.iterations >= saved_i

    def test_abort_resume_with_default_speculation(self, tmp_path):
        # DEFAULT chunk growth + deep pipeline (unlike BASE, which pins
        # them off): the checkpoint must capture the PROCESSED chunk's
        # recurrence triple while `dev` already holds speculated later
        # state, and growth pacing (n_chunks) must survive the resume
        n, k = 300, 5
        A = _slow_diag(n)
        kw = dict(block_size=5, eig_poll_cadence=4, max_kryl_dim=280,
                  tol=1e-9)
        ref = rt.rbl(A, k, cfg=RBLConfig(**kw))
        ck = str(tmp_path / "sweep_spec.npz")
        cfg = RBLConfig(**kw, sweep_checkpoint_path=ck,
                        fault_inject_abort_after_chunks=2)
        with pytest.raises(rt.SweepAborted):
            rt.rbl(A, k, cfg=cfg)
        assert os.path.exists(ck)
        res = rt.rbl(A, k, cfg=cfg.replace(
            fault_inject_abort_after_chunks=None))
        assert res.converged
        np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                                   rtol=1e-10)
        assert not os.path.exists(ck)

    def test_resume_with_host_offload_tier(self, tmp_path):
        # small device cap → the snapshot spans pinned-host panels + device
        n, k = 300, 5
        A = _slow_diag(n)
        kw = dict(BASE, basis_device_cap_cols=60)
        ref = rt.rbl(A, k, cfg=RBLConfig(**kw))
        ck = str(tmp_path / "sweep_offload.npz")
        cfg = RBLConfig(**kw, sweep_checkpoint_path=ck,
                        fault_inject_abort_after_chunks=6)
        with pytest.raises(rt.SweepAborted):
            rt.rbl(A, k, cfg=cfg)
        assert os.path.exists(ck)
        res = rt.rbl(A, k, cfg=cfg.replace(
            fault_inject_abort_after_chunks=None))
        assert res.converged
        np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                                   rtol=1e-10)
        assert not os.path.exists(ck)

    def test_shape_mismatch_raises(self, tmp_path):
        n, k = 300, 5
        A = _slow_diag(n)
        ck = str(tmp_path / "sweep_mismatch.npz")
        cfg = RBLConfig(**BASE, sweep_checkpoint_path=ck,
                        fault_inject_abort_after_chunks=3)
        with pytest.raises(rt.SweepAborted):
            rt.rbl(A, k, cfg=cfg)
        with pytest.raises(ValueError, match="mismatch"):
            rt.rbl(_slow_diag(200), k, cfg=cfg.replace(
                fault_inject_abort_after_chunks=None))

    def test_resume_on_mesh(self, tmp_path):
        # abort + resume with everything row-sharded over 8 virtual
        # devices: load_snapshot and the recurrence triple must re-shard
        import jax

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from rbl.parallel.dist_spmm import ShardedCooSpMM
        from rbl.parallel.mesh import make_row_mesh

        mesh = make_row_mesh(8)
        n, k = 320, 5
        A = _slow_diag(n)
        kw = dict(BASE, mesh=mesh)
        Ash = ShardedCooSpMM.from_scipy(A, mesh)
        ref = rt.rbl(Ash, k, cfg=RBLConfig(**kw))
        ck = str(tmp_path / "sweep_mesh.npz")
        cfg = RBLConfig(**kw, sweep_checkpoint_path=ck,
                        fault_inject_abort_after_chunks=3)
        with pytest.raises(rt.SweepAborted):
            rt.rbl(Ash, k, cfg=cfg)
        res = rt.rbl(Ash, k, cfg=cfg.replace(
            fault_inject_abort_after_chunks=None))
        assert res.converged
        np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues,
                                   rtol=1e-10)

    def test_restarted_strips_sweep_checkpoint(self, tmp_path):
        # rbl_restarted's fault tolerance is the RestartState boundary
        # file; the main solver's mid-sweep knob must not leak into its
        # inner sweeps (they would share one file across restarts)
        from rbl.solver.restarted import rbl_restarted

        ck = str(tmp_path / "never_written.npz")
        A = _slow_diag(200)
        cfg = RBLConfig(block_size=1, tol=1e-7, restart_kryl_dim=60,
                        sweep_checkpoint_path=ck)
        res = rbl_restarted(A, 3, cfg=cfg)
        assert res.converged
        np.testing.assert_allclose(res.eigenvalues, [200, 199, 198],
                                   rtol=1e-9)
        assert not os.path.exists(ck)

    def test_checkpoint_roundtrip_state(self, tmp_path):
        from rbl.utils.checkpoint import (
            load_sweep_state,
            save_sweep_state,
        )

        path = str(tmp_path / "state.npz")
        rng = np.random.default_rng(0)
        state = dict(
            n=100, b=4, i=7, flag=True, x=2.5,
            arr=rng.standard_normal((5, 4)),
            B_hist={1: rng.standard_normal((4, 4)),
                    3: rng.standard_normal((4, 4))},
        )
        save_sweep_state(path, state)
        out = load_sweep_state(path)
        assert out["n"] == 100 and out["b"] == 4 and out["i"] == 7
        assert out["flag"] is True and out["x"] == 2.5
        np.testing.assert_array_equal(out["arr"], state["arr"])
        assert sorted(out["B_hist"]) == [1, 3]
        np.testing.assert_array_equal(out["B_hist"][3],
                                      state["B_hist"][3])
