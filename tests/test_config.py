"""RBLConfig resolution logic (no reference counterpart — the reference
hardcodes every knob, SURVEY §5 config bullet)."""

import jax.numpy as jnp
import pytest

from rbl.config import RBLConfig


def test_qr_method_resolution():
    assert RBLConfig(compute_dtype=jnp.float64).resolved_qr_method() == \
        "householder"
    assert RBLConfig(compute_dtype=jnp.float32).resolved_qr_method() == \
        "cholqr2"
    assert RBLConfig(qr_method="cholqr3").resolved_qr_method() == "cholqr3"


def test_invalid_knobs_raise():
    with pytest.raises(ValueError):
        RBLConfig(tol=0.0)
    with pytest.raises(ValueError):
        RBLConfig(qr_method="nope")


def test_gpu_facing_defaults():
    """f32 products default to IEEE f32 ("highest": TF32's 4.9e-4 unit
    roundoff is above the √eps_f32 semi-orthogonality bar), and no solve
    re-dispatches itself after a fault unless asked to."""
    cfg = RBLConfig()
    assert cfg.matmul_precision == "highest"
    assert cfg.fault_retries == 0
