"""Multi-process batched window solves on ``torch.distributed``.

One process per device.  The global mesh has axes ("dp", "fp"):
adjacent ranks form an fp group, which splits each window's observation
rows and chains and sums its Schur blocks with ``all_reduce``; the dp
axis spreads independent windows (multi-sequence replay) over the groups.
Each process feeds its own share of the window batch.  The JAX package
lays the same mesh over its devices and lets XLA place the collectives;
here they are ``torch.distributed`` calls: NCCL between CUDA devices,
gloo on the CPU (or by name, e.g. for two processes sharing one card,
which NCCL refuses; gloo then reduces through host memory).

A torchrun launch (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``) is picked up by ``initialize_from_env``;
``run_ranks`` starts a local group of processes itself (tests, the dry
run, the chip smoke test).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
from torch.multiprocessing import ProcessRaisedException, start_processes
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_map

from ..core.state import TangentLayout
from ..device import full_precision, resolve_device
from ..solver.gauss_newton import DoglegConfig
from .mesh import (OBS_FIELDS, _solve_one, check_divisible, fp_shard,
                   mesh_device)
from .problems import VIWindowProblem
from .problems_gnss import RTK_FP_FIELDS, RTKWindowProblem, _solve_one_rtk

# the longest a collective may wait for its peers before the group fails,
# and the longest ``run_ranks`` lets a group run (a peer that raised or
# hangs ends the run instead of blocking it)
TIMEOUT_S = 300.0


def _backend(dev: torch.device, backend):
    if backend is None:
        return "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo") or (dev.type == "cpu"
                                           and backend == "nccl"):
        raise ValueError(f"no {backend!r} process group for {dev.type}")
    return backend


def init_group(rank: int, world_size: int, init_method: str, device=None,
               backend=None, local_rank: int | None = None):
    """Join the default process group: NCCL on ``cuda`` (the default
    device), gloo on the CPU or when ``backend="gloo"`` is asked for.  On
    CUDA this process takes device ``local_rank`` (default: ``rank``
    modulo the visible devices)."""
    dev = resolve_device(device)
    name = _backend(dev, backend)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        torch.cuda.set_device(rank % n if local_rank is None
                              else local_rank)
    dist.init_process_group(
        name, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))


def initialize_from_env(device=None, backend=None) -> bool:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``).  Returns False, and
    does nothing, when those variables are absent."""
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return False
    init_group(int(env["RANK"]), int(env["WORLD_SIZE"]), "env://", device,
               backend, int(env.get("LOCAL_RANK", env["RANK"])))
    return True


def global_mesh(fp: int = 1, device=None) -> DeviceMesh:
    """The ("dp", "fp") mesh of shape (world // fp, fp) over the default
    process group: ranks r with the same r // fp share an fp group
    (adjacent ranks, as the JAX mesh takes adjacent devices).  Raises on a
    world size that ``fp`` does not divide."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_from_env or "
                           "init_group first")
    dev = resolve_device(device)
    world = dist.get_world_size()
    check_divisible("the world size", world, fp, "fp")
    if dev.type == "cpu" and dist.get_backend() != "gloo":
        raise ValueError(f"a cpu mesh needs gloo, not {dist.get_backend()}")
    ranks = torch.arange(world).reshape(world // fp, fp)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    groups = {}
    # every rank creates every group, in the same order
    for axis, lines in (("dp", ranks.T), ("fp", ranks)):
        for line in lines.tolist():
            pg = dist.new_group(line, timeout=timeout)
            if dist.get_rank() in line:
                groups[axis] = pg
    return DeviceMesh.from_group([groups["dp"], groups["fp"]], dev.type,
                                 mesh=ranks, mesh_dim_names=("dp", "fp"))


def distribute_local_problems(mesh: DeviceMesh,
                              probs_local: VIWindowProblem) -> VIWindowProblem:
    """This process's fp share of its local window batch (the batch its dp
    group solves; every fp peer passes the same one), on its device."""
    return fp_shard(mesh, probs_local, OBS_FIELDS, mesh_device(mesh))


def multihost_vi_solve(mesh: DeviceMesh, probs: VIWindowProblem,
                       lay: TangentLayout, cfg: DoglegConfig):
    """The dp x fp VI solve of this process's share from
    ``distribute_local_problems``: (state, cost, n_accepted) of its
    windows."""
    full_precision()
    return _solve_one(probs, lay, cfg, fp_group=mesh.get_group("fp"))


def distribute_local_rtk_problems(mesh: DeviceMesh,
                                  probs_local: RTKWindowProblem
                                  ) -> RTKWindowProblem:
    """The flagship counterpart of ``distribute_local_problems``: the
    observation rows, the chains and their hidden states cut to this
    process's fp share, on its device."""
    return fp_shard(mesh, probs_local, RTK_FP_FIELDS, mesh_device(mesh))


def multihost_rtk_solve(mesh: DeviceMesh, probs: RTKWindowProblem,
                        lay: TangentLayout, cfg: DoglegConfig, cap: int):
    """The dp x fp flagship solve of this process's share from
    ``distribute_local_rtk_problems``: (win, hid, cost, n_accepted, X) of
    its windows, ``hid`` of its chains."""
    full_precision()
    return _solve_one_rtk(probs, lay, cfg, cap,
                          fp_group=mesh.get_group("fp"))


def _gather(x, group, dim: int):
    """``x`` of every process of ``group``, concatenated along ``dim`` in
    rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_vi_results(mesh: DeviceMesh, out):
    """The whole batch's (state, cost, n_accepted) on every process, from
    each process's ``multihost_vi_solve`` / ``sharded_vi_solve`` result."""
    dp = mesh.get_group("dp")
    return tree_map(lambda x: _gather(x, dp, 0), out)


def gather_rtk_results(mesh: DeviceMesh, out):
    """The whole batch's (win, hid, cost, n_accepted, X) on every process:
    windows gathered over dp, hidden states over fp (chains), then dp."""
    win, hid, cost, nacc, X = out
    dp, fp = mesh.get_group("dp"), mesh.get_group("fp")
    hid = tree_map(lambda x: _gather(_gather(x, fp, 1), dp, 0), hid)
    win, cost, nacc, X = tree_map(lambda x: _gather(x, dp, 0),
                                  (win, cost, nacc, X))
    return win, hid, cost, nacc, X


def _rank_main(rank, fn, world_size, init_method, device, backend, args,
               results):
    if resolve_device(device).type == "cpu":
        torch.set_num_threads(1)
    init_group(rank, world_size, init_method, device, backend)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    results.put((rank, tree_map(lambda x: x.detach().cpu().numpy()
                                if isinstance(x, torch.Tensor) else x, out)))


def run_ranks(fn, world_size: int, args=(), device=None, backend=None):
    """Run ``fn(rank, *args)`` in ``world_size`` new processes joined in one
    process group (``init_group``; a ``file://`` store in a temporary
    directory, so concurrent groups never share a port), and return the
    results in rank order, tensors as numpy arrays.  ``fn`` must be
    importable by name (a module-level function).  A rank that raises or
    dies fails the call with its traceback or exit code, a group still
    running after ``TIMEOUT_S`` fails it too, and either way every rank
    still running is stopped."""
    results = multiprocessing.get_context("spawn").SimpleQueue()
    done = {}

    def drain():
        # a rank blocks in ``put`` until its result is read off the pipe
        while not results.empty():
            rank, out = results.get()
            done[rank] = out

    deadline = time.monotonic() + TIMEOUT_S
    with tempfile.TemporaryDirectory() as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        group = start_processes(
            _rank_main, (fn, world_size, init_method, device, backend, args,
                         results), nprocs=world_size, join=False)
        try:
            # join raises on a rank's exception or death, and stops the
            # others after a grace period in which they may fail too
            while not group.join(timeout=1.0, grace_period=5.0):
                drain()
                if time.monotonic() > deadline:
                    for p in group.processes:
                        p.kill()
                        p.join()
                    raise TimeoutError(f"the group of {world_size} ranks "
                                       f"did not finish in {TIMEOUT_S:.0f} s")
        except ProcessRaisedException as e:
            # the failure join reports may be a peer whose collective broke
            # when the failed rank's connection closed: name every rank
            # that raised
            others = ""
            for r, path in enumerate(group.error_files):
                if r != e.error_index and os.path.exists(path):
                    with open(path, "rb") as fh:
                        others += f"\n-- Process {r} also failed:\n" \
                            + pickle.load(fh)
            raise RuntimeError(f"{e}{others}") from e
        drain()
    return [done[r] for r in range(world_size)]
