"""The port's trainers and both training scripts on the CPU for a step or
two: epochs, checkpoints and resume of the Deep3D trainer, the stereo
trainers' steps and BatchNorm statistics on 16-bit ground truth, the
scripts' synthetic and KITTI 2015 modes with their exports, and the entry
points' refusal to run on a missing card."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from stereo_tpu_torch.core.config import TrainerConfig
from stereo_tpu_torch.models import (Deep3D, build_stereo_model,
                                     load_npz_meta, load_or_init_params)
from stereo_tpu_torch.scripts import (train_right_view_synthesis_model,
                                      train_stereo_model)
from stereo_tpu_torch.train import (Kitti2015StereoDataset, StereoTrainer,
                                    SyntheticDeep3DTrainer,
                                    SyntheticStereoTrainer, Trainer)

import torch_threads

torch_threads.take_worker_share()


class SmallViews:
    """A KittiStereoDataset stand-in at 128x256 / 32x64: seeded views in
    0..1, the right view the left rolled by 3 columns."""

    def __init__(self, n=4):
        rng = np.random.default_rng(4)
        self.items = []
        for _ in range(n):
            full = rng.uniform(0, 1, (3, 128, 256)).astype(np.float32)
            down = full.reshape(3, 32, 4, 64, 4).mean(axis=(2, 4))
            self.items.append((full, down, np.roll(full, -3, axis=-1)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_trainer_epochs_resume_and_export(tmp_path):
    """An epoch with its checkpoint, then a resumed trainer and the
    original run the next epoch, at the StepLR's next rate, to the same
    parameters (dropout keyed by the epoch, as in JAX); the export carries
    the native training size."""
    cfg = TrainerConfig(n_epochs=2, batch_size=2, learning_rate=1e-4,
                        step_size=1, save_path=str(tmp_path / "state.pt"),
                        log_every=0)
    first = Trainer(Deep3D((32, 64)), cfg, seed=0, device="cpu")
    losses = first.train(SmallViews(2), n_epochs=1)
    assert len(losses) == 1 and np.isfinite(losses[0]) and first.epoch == 1
    assert first.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4)
    second = Trainer(Deep3D((32, 64)), cfg, seed=9, device="cpu")
    second.load_checkpoint(cfg.save_path)
    assert second.epoch == 1
    first.config = second.config = cfg.replace(save_path=None)
    first.train(SmallViews(2))
    second.train(SmallViews(2))
    assert second.optimizer.param_groups[0]["lr"] == pytest.approx(1e-5)
    for (name, a), b in zip(first.model.state_dict().items(),
                            second.model.state_dict().values()):
        assert torch.equal(a, b), name
    path = str(tmp_path / "deep3d.npz")
    first.export_inference_variables(path)
    assert load_npz_meta(path)["full_shape"].tolist() == [384, 1280]


def test_one_step_without_dropout_is_deterministic():
    """With dropout off, two trainers from the same seed take the same
    step (the smoke's CPU-against-card check relies on it)."""
    views = SmallViews(2)
    batch = [torch.from_numpy(np.stack(x)) for x in zip(*views.items)]
    steps = []
    for _ in range(2):
        trainer = Trainer(Deep3D((32, 64)), TrainerConfig(), seed=3,
                          device="cpu", dropout=False)
        loss = trainer.train_step(*batch)
        steps.append((float(loss), trainer.model.state_dict()))
    assert steps[0][0] == steps[1][0]
    assert all(torch.equal(steps[0][1][k], steps[1][1][k])
               for k in steps[0][1])


def write_kitti2015(root, n=2, shape=(40, 70)):
    rng = np.random.default_rng(6)
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        for sub in ("image_2", "image_3"):
            Image.fromarray(rng.integers(0, 256, (*shape, 3)).astype(
                np.uint8)).save(os.path.join(root, sub, f"{i:06d}_10.png"))
        Image.fromarray(rng.integers(0, 20 * 256, shape).astype(
            np.uint16)).save(os.path.join(root, "disp_occ_0",
                                          f"{i:06d}_10.png"))


def test_stereo_trainers_step_and_keep_statistics_finite(tmp_path):
    """``StereoTrainer`` for an epoch on written 16-bit-GT triplets and
    ``SyntheticStereoTrainer`` for two steps: finite losses, parameters
    moved, BatchNorm statistics finite and moved."""
    root = str(tmp_path / "kitti2015")
    write_kitti2015(root)
    files = [sorted(os.path.join(root, s, f) for f in os.listdir(
        os.path.join(root, s))) for s in ("image_2", "image_3",
                                          "disp_occ_0")]
    trainer = StereoTrainer("gwcnet", 16, TrainerConfig(
        n_epochs=1, batch_size=2, learning_rate=1e-3), device="cpu")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    losses = trainer.train(Kitti2015StereoDataset(*files, crop=(32, 64)))
    assert len(losses) == 1 and np.isfinite(losses[0])
    after = trainer.model.state_dict()
    assert not torch.equal(before["classif3.Conv_0.weight"],
                           after["classif3.Conv_0.weight"])
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert all(bool(torch.isfinite(after[k]).all()) for k in stats)
    assert any(not torch.equal(before[k], after[k]) for k in stats)

    synth = SyntheticStereoTrainer("msnet2d", 16, 32, 64, batch_size=2,
                                   warmup_steps=1, total_steps=4, chunk=1,
                                   device="cpu")
    losses = synth.train(2)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert synth.step_count == 2
    assert synth.optimizer.param_groups[0]["lr"] == pytest.approx(
        synth.schedule(1))


def test_scripts_run_on_the_cpu(tmp_path):
    """Both training scripts for a step or two: the synthetic modes of
    each (with export and resume), and KITTI 2015 mode of the stereo
    script; every export loads."""
    out = str(tmp_path / "deep3d.npz")
    losses = train_right_view_synthesis_model.main([
        "--synthetic", "--crop", "128", "256", "--steps", "2", "--chunk",
        "1", "--export-every", "2", "--batch-size", "1",
        "--disparity-loss-weight", "0.1", "--ce-loss-weight", "0.2",
        "--photo-target", "oracle", "--export-dir", out, "--device", "cpu"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert load_npz_meta(out)["full_shape"].tolist() == [128, 256]
    with open(tmp_path / "deep3d_synthetic_losses.json") as f:
        assert json.load(f)["losses"] == losses

    ckpt = str(tmp_path / "msnet3d.npz")
    args = ["--model", "msnet3d", "--synthetic", "--max-disparity", "16",
            "--crop", "32", "64", "--steps", "2", "--warmup-steps", "1",
            "--chunk", "1",
            "--batch-size", "1", "--checkpoint", ckpt, "--device", "cpu"]
    assert len(train_stereo_model.main(args)) == 2
    assert len(train_stereo_model.main(args + ["--resume"])) == 2

    root = str(tmp_path / "kitti2015")
    write_kitti2015(root)
    export = str(tmp_path / "gwcnet.npz")
    losses = train_stereo_model.main([
        "--model", "gwcnet", "--data-dir", root, "--max-disparity", "16",
        "--crop", "32", "64", "--n-epochs", "1", "--batch-size", "2",
        "--checkpoint", str(tmp_path / "gwcnet_train.pt"), "--export-dir",
        export, "--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    model = build_stereo_model("gwcnet", 16)
    assert load_or_init_params(model, "gwcnet", checkpoint_dir=export) == \
        export


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: Trainer(Deep3D((32, 64))),
                  lambda: StereoTrainer("gwcnet", 16),
                  lambda: SyntheticStereoTrainer("gwcnet", 16, 32, 64),
                  lambda: SyntheticDeep3DTrainer(128, 256),
                  lambda: train_stereo_model.main(
                      ["--model", "gwcnet", "--synthetic", "--steps", "1",
                       "--checkpoint", str(tmp_path / "g.npz")])):
        with pytest.raises(RuntimeError, match="is_available"):
            build()
