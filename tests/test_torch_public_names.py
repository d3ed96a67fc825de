"""The port's public surface against the JAX package's, on the CPU.

  - every name a JAX subpackage's ``__init__.py`` re-exports (read with
    ``ast`` from the JAX file, not imported) imports through the port's
    subpackage of the same name, in a process that cannot import JAX;
  - ``preintegration.preintegrate_sequence`` against JAX's on a batch of
    intervals of ragged validity, float64, at
    tests/test_torch_foundation.py's tolerance (ATOL, scaled by each
    field's largest value).
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtk_visual_inertial_navigation_tpu.preintegration import \
    preintegrate_sequence as jpreintegrate_sequence
from rtk_visual_inertial_navigation_tpu_torch.parallel.problems import \
    IMU_NOISE
from rtk_visual_inertial_navigation_tpu_torch.preintegration import \
    preintegrate_sequence as tpreintegrate_sequence

from test_torch_foundation import ATOL

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "rtk_visual_inertial_navigation_tpu")
SUBPACKAGES = ("ops", "factors", "geodesy", "solver", "core",
               "preintegration")


def _reexported(sub):
    """The names ``from ... import`` binds in the JAX subpackage's
    ``__init__.py``."""
    with open(os.path.join(JAX_PKG, sub, "__init__.py")) as f:
        tree = ast.parse(f.read())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


# In a fresh interpreter where ``jax`` cannot be imported (as on a machine
# without JAX), import the subpackage alone and list the names it lacks.
# In this process, importing any module of a subpackage binds it on the
# package, so a missing re-export of a submodule would go unseen.
_PROBE = """
import sys
sys.modules["jax"] = None
import rtk_visual_inertial_navigation_tpu_torch.{sub} as mod
print([n for n in {names!r} if n not in vars(mod)])
"""


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_reexports_match_jax(sub):
    names = _reexported(sub)
    assert names, f"the JAX {sub}/__init__.py re-exports nothing"
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(sub=sub, names=names)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == "[]", f"{sub} lacks {out.stdout.strip()}"


def test_preintegrate_sequence_matches_jax():
    rng = np.random.default_rng(11)
    n, S = 4, 10
    dts = np.full((n, S), 0.005) + 1e-3 * rng.random((n, S))
    accs = rng.normal(size=(n, S, 3)) + np.array([0, 0, 9.81])
    gyrs = 0.5 * rng.normal(size=(n, S, 3))
    valid = np.arange(S) < np.array([S, 7, 3, 9])[:, None]   # ragged
    ba, bg = 0.1 * rng.normal(size=(n, 3)), 0.01 * rng.normal(size=(n, 3))
    ref = jax.jit(jpreintegrate_sequence)(
        *map(jnp.asarray, (dts, accs, gyrs, valid, ba, bg)), IMU_NOISE)
    got = tpreintegrate_sequence(*map(torch.from_numpy, (
        dts, accs, gyrs, valid, ba, bg)), IMU_NOISE)
    assert got._fields == ref._fields
    for k in got._fields:
        r = np.asarray(getattr(ref, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), r, rtol=0,
                                   atol=ATOL * max(np.abs(r).max(), 1.0),
                                   err_msg=k)
