"""Former package names stay importable as the very modules of ``rbl``
(rbl/_alias.py), with a DeprecationWarning."""

import importlib
import os
import pkgutil
import subprocess
import sys
import warnings

import pytest

import rbl
import rbl.ops.spmm.pallas_bsr as pb
from rbl._alias import _AliasFinder, alias_package

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_alias_package_serves_the_same_modules():
    old = "rbl_former_name_for_test"
    try:
        with pytest.warns(DeprecationWarning, match="renamed `rbl`"):
            alias_package(old, "rbl")
        assert importlib.import_module(old) is rbl
        sub = importlib.import_module(old + ".ops.spmm.pallas_bsr")
        assert sub is pb
        from rbl_former_name_for_test.ops.spmm import pallas_bsr
        assert pallas_bsr.BlockSparseOperator is pb.BlockSparseOperator
        # a second call installs no second finder
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            alias_package(old, "rbl")
        assert sum(isinstance(f, _AliasFinder) and f.old == old
                   for f in sys.meta_path) == 1
    finally:
        sys.meta_path[:] = [f for f in sys.meta_path
                            if not (isinstance(f, _AliasFinder)
                                    and f.old == old)]
        for name in [m for m in sys.modules
                     if m == old or m.startswith(old + ".")]:
            del sys.modules[name]


def _former_names():
    return [m.name for m in pkgutil.iter_modules([ROOT])
            if m.ispkg and m.name.startswith("rbl_")]


@pytest.mark.parametrize("name", _former_names())
def test_former_package_name_is_rbl(name):
    """Checked in a fresh interpreter: the warning fires on first import
    only."""
    code = (
        "import importlib, warnings\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        f"    m = importlib.import_module({name!r})\n"
        f"    s = importlib.import_module({name!r} + '.ops.spmm.pallas_bsr')\n"
        "import rbl, rbl.ops.spmm.pallas_bsr as pb\n"
        "assert m is rbl and s is pb\n"
        "assert any(issubclass(x.category, DeprecationWarning) for x in w)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
