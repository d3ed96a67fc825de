"""PyTorch / CUDA port of ``rtk_visual_inertial_navigation_tpu``.

The module layout and function names follow the JAX package, so each
function here has a counterpart of the same name there.  The port imports
``torch`` only.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.

Ported so far: the flagship batched RTK-VI window solve
(``parallel.problems_gnss.batched_rtk_solve``, its projection step on the
hand-written CUDA kernel ``ops/csrc/proj_segments.cu``), the batched VI
window solve (``parallel.batched_vi_solve``), the batched f32 Cholesky
kernels of every f32 step (``ops/pallas_chol_lanes.py``), the
estimator pipeline (``pipeline.Estimator``, driven by ``pipeline.replay``
over ``sim.simulate``'s sequences), its offline entry points (rosbag
replay ``io.reference_bag.replay_bag`` over the C++ reader in ``native/``,
the bag writer, the result CSV, and the demo ``examples/run_sim_demo.py``),
the image frontend (``models.cameras``, ``frontend.tracker``,
``frontend.tracker_frontend``) and the dp x fp sharded solves on
``torch.distributed`` (``parallel.sharded_rtk_solve``,
``parallel.sharded_vi_solve``, ``parallel.multihost``).

The public surface is complete: every module and every public name of the
JAX package, the subpackages' re-exports included, has a counterpart here,
except two.  ``utils/compile_cache.py`` turns on JAX's persistent XLA
cache, and nothing here is compiled by XLA (the CUDA and C++ builds cache
their libraries by source hash in ``build/``).  ``LANES``
(``ops/pallas_chol_lanes.py``) is the TPU's vector lane width, the batch
tile of the Pallas kernel; the CUDA kernels tile by thread blocks and
clusters instead.
"""

from .device import full_precision, resolve_device  # noqa: F401
