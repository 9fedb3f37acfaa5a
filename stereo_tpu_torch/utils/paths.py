"""Project-relative paths and run-directory helpers (port of
``stereo_tpu/utils/paths.py``)."""

from __future__ import annotations

import os
from datetime import datetime

PROJECT_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DATA_ROOT = os.path.join(PROJECT_ROOT, "data")

# Committed right-view-synthesis (Deep3D) weights, shared with stereo_tpu.
DEEP3D_CHECKPOINT_DIR = os.path.join(DATA_ROOT, "checkpoints", "deep3d")
MODEL_CHECKPOINT_ROOT = os.path.join(DATA_ROOT, "checkpoints")


def model_checkpoint_dir(model_name: str) -> str:
    """Checkpoint path of a model, without the ``.npz`` suffix."""
    return os.path.join(MODEL_CHECKPOINT_ROOT, model_name)


def project_relative_path(*parts: str) -> str:
    return os.path.join(PROJECT_ROOT, *parts)


def data_path(*parts: str) -> str:
    return os.path.join(DATA_ROOT, *parts)


def timestamp_folder_name() -> str:
    """The current local time as ``YYYY-mm-dd_HH-MM-SS``, the name of a
    run's output folder."""
    return datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
