"""Kernel launch counts of the port's CUDA wrappers.

Each wrapper adds one under its kernel's name where it launches the
kernel; a run resets and reads the counter to show which kernels its main
path went through.
"""

import collections

LAUNCHES = collections.Counter()
