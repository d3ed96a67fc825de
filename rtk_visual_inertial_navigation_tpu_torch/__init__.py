"""PyTorch / CUDA port of ``rtk_visual_inertial_navigation_tpu``.

The module layout and function names follow the JAX package, so each
function here has a counterpart of the same name there.  The port imports
``torch`` only.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.

The ported slice is the flagship batched RTK-VI window solve
(``parallel.problems_gnss.batched_rtk_solve``), whose projection step runs
through the hand-written CUDA kernel ``ops/csrc/proj_segments.cu``.
"""

from .device import full_precision, resolve_device  # noqa: F401
