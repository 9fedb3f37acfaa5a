"""Training of the port's networks (port of ``stereo_tpu/train``): Deep3D
on KITTI drives and on generated scenes, the stereo networks on KITTI 2015
style data and on generated scenes, with the scene generator and its
JAX-compatible key stream (``prng``)."""

from .kitti_dataset import KittiStereoDataset, batch_iterator
from .stereo_trainer import Kitti2015StereoDataset, StereoTrainer
from .synthetic import (SyntheticDeep3DTrainer, SyntheticStereoTrainer,
                        synthetic_stereo_batch, synthetic_stereo_scene)
from .trainer import Trainer, make_optimizer

__all__ = ["KittiStereoDataset", "batch_iterator", "Kitti2015StereoDataset",
           "StereoTrainer", "SyntheticDeep3DTrainer", "SyntheticStereoTrainer",
           "synthetic_stereo_batch", "synthetic_stereo_scene",
           "Trainer", "make_optimizer"]
