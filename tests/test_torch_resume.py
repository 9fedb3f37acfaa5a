"""``--resume`` of the port's training scripts from the checkpoints either
package writes: the Deep3D script from a JAX ``Trainer``'s Orbax directory
(a Flax-named stand-in for Deep3D, as ``tests/test_torch_orbax.py`` makes
its trees) starts at the tree's epoch and saves back into that directory
as an Orbax tree that JAX's ``Trainer.load_checkpoint`` reads; a
``torch.save`` file still resumes as a file; the stereo script resumes
from an Orbax directory the same way."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from stereo_tpu.core.config import TrainerConfig as JaxTrainerConfig
from stereo_tpu.train import Trainer as JaxTrainer

import stereo_tpu_torch.train as port_train
from stereo_tpu_torch.core.config import TrainerConfig
from stereo_tpu_torch.models import (flatten_variables,
                                     flax_arrays_from_state_dict,
                                     nest_variables)
from stereo_tpu_torch.scripts import (train_right_view_synthesis_model,
                                      train_stereo_model)
from stereo_tpu_torch.train import StereoTrainer, Trainer
from stereo_tpu_torch.utils.orbax import read_tree


class TinyDeep3D(torch.nn.Module):
    """Deep3D's call (left_full, left_down, generator) -> right view, with
    one Flax-named layer, standing in for Deep3D's 78M parameters."""

    prob_volume_scale = 4

    def __init__(self):
        super().__init__()
        self.Conv_0 = torch.nn.Conv2d(3, 3, 3, padding=1)

    def forward(self, left_full, left_down, generator=None):
        return self.Conv_0(left_full)


class SmallViews:
    """A ``KittiStereoDataset`` stand-in: four seeded (full, down, right)
    views at 8x16 / 2x4."""

    def __init__(self, drive_dirs=None):
        rng = np.random.default_rng(3)
        self.items = []
        for _ in range(4):
            full = rng.uniform(0, 1, (3, 8, 16)).astype(np.float32)
            down = full.reshape(3, 2, 4, 4, 4).mean(axis=(2, 4))
            self.items.append((full, down, np.roll(full, -1, axis=-1)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture
def tiny_script(monkeypatch):
    """The Deep3D script's KITTI mode on ``TinyDeep3D`` and ``SmallViews``;
    the trainers it makes are appended to the returned list."""
    made = []

    def make_trainer(**kwargs):
        made.append(Trainer(TinyDeep3D(), **kwargs))
        return made[-1]

    monkeypatch.setattr(port_train, "Trainer", make_trainer)
    monkeypatch.setattr(port_train, "KittiStereoDataset", SmallViews)
    return made


def run_script(tmp_path, checkpoint, n_epochs, resume):
    return train_right_view_synthesis_model.main(
        ["--drive-dirs", str(tmp_path), "--checkpoint", checkpoint,
         "--n-epochs", str(n_epochs), "--batch-size", "2",
         "--learning-rate", "1e-3", "--export-dir",
         str(tmp_path / "deep3d.npz"), "--device", "cpu"]
        + (["--resume"] if resume else []))


def jax_tree(model):
    return jax.tree_util.tree_map(
        jnp.asarray, nest_variables(flax_arrays_from_state_dict(model)))


def jax_trainer(model):
    return JaxTrainer(object(), JaxTrainerConfig(learning_rate=1e-3),
                      variables={"params": jax_tree(model)["params"]})


def test_deep3d_script_resumes_from_a_jax_orbax_directory(tmp_path, capsys,
                                                          tiny_script):
    """JAX's trainer, two optax steps, epoch 1, saved to the checkpoint
    directory; the script with ``--resume`` starts there, trains epoch 1
    only (two steps), and its epoch's save lands in the same directory as
    an Orbax tree: JAX's ``load_checkpoint`` reads epoch 2, the four steps'
    count and the port's parameters bit for bit."""
    theirs = jax_trainer(TinyDeep3D())
    rng = np.random.default_rng(0)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32),
            theirs.params)
        updates, theirs.opt_state = theirs.optimizer.update(
            grads, theirs.opt_state, theirs.params)
        theirs.params = optax.apply_updates(theirs.params, updates)
    theirs.epoch = 1
    ckpt = str(tmp_path / "deep3d_train")
    theirs.save_checkpoint(ckpt)

    losses = run_script(tmp_path, ckpt, n_epochs=2, resume=True)
    assert "Resumed from epoch 1." in capsys.readouterr().out
    assert len(losses) == 1 and np.isfinite(losses[0])
    (port,) = tiny_script
    assert port.epoch == 2
    assert os.path.isdir(ckpt)

    again = jax_trainer(TinyDeep3D())
    again.load_checkpoint(ckpt)
    assert again.epoch == 2 and int(again.opt_state.count) == 4
    got = flax_arrays_from_state_dict(port.model)
    for key, value in flatten_variables({"params": again.params}).items():
        np.testing.assert_array_equal(got[key], np.asarray(value),
                                      err_msg=key)


def test_deep3d_script_still_resumes_from_a_file(tmp_path, capsys,
                                                 tiny_script):
    """A fresh run writes its ``torch.save`` file; ``--resume`` then starts
    at its epoch and keeps writing a file."""
    ckpt = str(tmp_path / "deep3d_train.pt")
    assert len(run_script(tmp_path, ckpt, n_epochs=1, resume=False)) == 1
    assert os.path.isfile(ckpt)
    assert "Resumed" not in capsys.readouterr().out
    assert len(run_script(tmp_path, ckpt, n_epochs=2, resume=True)) == 1
    assert "Resumed from epoch 1." in capsys.readouterr().out
    assert os.path.isfile(ckpt)
    assert torch.load(ckpt, weights_only=True)["epoch"] == 2


@pytest.mark.parametrize("path,given,want", [
    ("missing", None, "torch"),
    ("file", None, "torch"),
    ("dir", None, "orbax"),
    ("missing", "orbax", "orbax")])
def test_save_checkpoint_format(tmp_path, path, given, want):
    """``save_checkpoint``'s default: an Orbax tree onto a directory (a
    resumed JAX checkpoint is saved back in place), else a ``torch.save``
    file; a given format wins."""
    (tmp_path / "dir").mkdir()
    torch.save({}, tmp_path / "file")
    trainer = Trainer(TinyDeep3D(), device="cpu")
    trainer.epoch = 3
    target = str(tmp_path / path)
    trainer.save_checkpoint(target, format=given)
    if want == "orbax":
        assert os.path.isdir(target) and int(read_tree(target)["epoch"]) == 3
    else:
        assert torch.load(target, weights_only=True)["epoch"] == 3


def write_kitti2015(root, n=2, shape=(40, 72)):
    """``n`` KITTI 2015 triplets: seeded views, 16-bit ground truth."""
    rng = np.random.default_rng(1)
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n):
        left = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        Image.fromarray(left).save(os.path.join(root, "image_2",
                                                f"{i:06d}_10.png"))
        Image.fromarray(np.roll(left, -4, axis=1)).save(
            os.path.join(root, "image_3", f"{i:06d}_10.png"))
        gt = np.full(shape, 4 * 256, np.uint16)
        Image.fromarray(gt).save(os.path.join(root, "disp_occ_0",
                                              f"{i:06d}_10.png"))


def test_stereo_script_resumes_from_an_orbax_directory(tmp_path, capsys):
    """MSNet2D's trainer saved as an Orbax tree at epoch 1; the stereo
    script's KITTI 2015 mode resumes there, trains epoch 1 and saves the
    tree back in place at epoch 2."""
    cfg = TrainerConfig(learning_rate=1e-3)
    first = StereoTrainer("msnet2d", 16, cfg, device="cpu")
    first.epoch = 1
    ckpt = str(tmp_path / "msnet2d_train")
    first.save_checkpoint(ckpt, format="orbax")
    root = str(tmp_path / "kitti2015")
    write_kitti2015(root)
    losses = train_stereo_model.main([
        "--model", "msnet2d", "--data-dir", root, "--max-disparity", "16",
        "--crop", "32", "64", "--n-epochs", "2", "--batch-size", "2",
        "--checkpoint", ckpt, "--resume", "--export-dir",
        str(tmp_path / "msnet2d.npz"), "--device", "cpu"])
    assert "Resumed from epoch 1." in capsys.readouterr().out
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert os.path.isdir(ckpt) and int(read_tree(ckpt)["epoch"]) == 2
    again = StereoTrainer("msnet2d", 16, cfg, device="cpu")
    again.load_checkpoint(ckpt)
    assert again.epoch == 2
