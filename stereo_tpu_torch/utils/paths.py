"""Project-relative paths (port of ``stereo_tpu/utils/paths.py``)."""

from __future__ import annotations

import os

PROJECT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_ROOT = os.path.join(PROJECT_ROOT, "data")

# Committed right-view-synthesis (Deep3D) weights, shared with stereo_tpu.
DEEP3D_CHECKPOINT_DIR = os.path.join(DATA_ROOT, "checkpoints", "deep3d")
