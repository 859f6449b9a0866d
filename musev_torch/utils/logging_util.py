"""Logging configuration and seeding (counterpart of ``musev_tpu/utils/logging_util.py``).

Reference: musev/logging.conf loaded at musev/__init__.py:1-9 (root INFO,
package DEBUG, console handler with file:line format) and mmcm's
set_all_seed. The port draws its randomness from explicit generators, so
``set_all_seed`` seeds Python's and numpy's RNGs for host-side code and
returns a seeded CPU ``torch.Generator`` for the port's draws.
"""

from __future__ import annotations

import logging
import random
import sys
from typing import Tuple

import numpy as np
import torch

_FORMAT = "%(asctime)s %(levelname)s [%(name)s %(filename)s:%(lineno)d] %(message)s"


def configure_logging(level: int = logging.INFO, package_level: int = logging.DEBUG):
    """Root at ``level`` (with a stdout handler unless it has a stream
    handler); the ``musev_torch`` logger at ``package_level``."""
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger()
    root.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in root.handlers):
        root.addHandler(handler)
    logging.getLogger("musev_torch").setLevel(package_level)


def set_all_seed(seed: int) -> Tuple[int, torch.Generator]:
    """Seed Python's and numpy's RNGs; return (seed, a CPU generator at seed)."""
    random.seed(seed)
    np.random.seed(seed)
    return seed, torch.Generator().manual_seed(seed)
