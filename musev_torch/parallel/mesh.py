"""The CLIs' ``--parallel`` topology (counterpart of ``musev_tpu/parallel/mesh.py``).

Only ``cli_topology``'s one-device case is ported: ``none``, ``fp`` and
``dp`` all run without a mesh when fewer than 2 CUDA devices are visible,
as the JAX CLI does on one device (mesh.py:52-54). The multi-device
topologies (frame parallelism over every (window, CFG, frame) row, data
parallelism over the window x CFG batch) are ROADMAP queue 1, item 15.
"""

from __future__ import annotations

import contextlib

import torch

TOPOLOGIES = ("none", "fp", "dp")


def cli_topology(topology: str):
    """``none``/``fp``/``dp`` -> (context manager, pipeline kwargs): a null
    context and no kwargs for ``none`` or on fewer than 2 CUDA devices.
    Raises ``ValueError`` for an unknown topology and
    ``NotImplementedError`` for ``fp`` or ``dp`` on 2 or more devices."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown parallel topology {topology!r}")
    n = torch.cuda.device_count()
    if topology == "none" or n < 2:
        return contextlib.nullcontext(), {}
    raise NotImplementedError(
        f"--parallel {topology} over {n} devices is not ported to musev_torch yet "
        "(ROADMAP queue 1, item 15)")
