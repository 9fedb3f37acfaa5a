"""Entry points of the port, run as modules::

    python -m stereo_tpu_torch.scripts.evaluate_depth_estimation_pipeline --drive-dirs DRIVE ...
    python -m stereo_tpu_torch.scripts.run_kitti_pipeline --drive-dir DRIVE
    python -m stereo_tpu_torch.scripts.run_middlebury_pipeline --middlebury-dir SCENES
    python -m stereo_tpu_torch.scripts.train_right_view_synthesis_model --synthetic ...
    python -m stereo_tpu_torch.scripts.train_stereo_model --model gwcnet --synthetic ...

They take the flags and defaults of the JAX package's scripts of the same
names, plus ``--device`` (default ``cuda``)."""
