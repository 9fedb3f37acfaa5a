"""Orbax checkpoints in the port against the JAX package: the port's zstd
decoder against ``zstandard``, its OCDBT store against tensorstore, trees
written by JAX's ``save_params`` and trainers read by the port bit for bit
and the port's read by JAX's ``load_params`` and ``load_checkpoint``, the
lookup order of ``load_or_init_params`` and ``RightViewSynthesis``, resumed
training on both sides, the refused formats, and the committed fixture
against its npz twin."""

import functools
import gzip
import json
import logging
import os
import shutil
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

from stereo_tpu.core.config import TrainerConfig as JaxTrainerConfig
from stereo_tpu.models import build_stereo_model as jax_build_stereo_model
from stereo_tpu.models import load_params as jax_load_params
from stereo_tpu.models import load_params_npz
from stereo_tpu.models import save_params as jax_save_params
from stereo_tpu.synthesis import RightViewSynthesis as JaxRightViewSynthesis
from stereo_tpu.train import StereoTrainer as JaxStereoTrainer
from stereo_tpu.train import Trainer as JaxTrainer

from stereo_tpu_torch import _native
from stereo_tpu_torch.core.config import TrainerConfig
from stereo_tpu_torch.models import (Deep3D, build_stereo_model,
                                     flax_arrays_from_state_dict,
                                     flatten_variables, init_deep3d_params,
                                     init_params, load_deep3d_checkpoint,
                                     load_or_init_params, load_params,
                                     nest_variables, save_params,
                                     state_dict_from_flax)
from stereo_tpu_torch.models.layers import BatchNorm
from stereo_tpu_torch.synthesis import RightViewSynthesis
from stereo_tpu_torch.scripts import export_rvs_model
from stereo_tpu_torch.train import StereoTrainer, Trainer
from stereo_tpu_torch.train import stereo_trainer as stereo_trainer_module
from stereo_tpu_torch.utils.ocdbt import OcdbtStore, write_ocdbt
from stereo_tpu_torch.utils.orbax import read_tree
from stereo_tpu_torch.utils.paths import model_checkpoint_dir

import torch_threads

torch_threads.take_worker_share()

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")

# Orbax warns on every restore without a template.
logging.getLogger("absl").setLevel(logging.ERROR)
# orbax, tensorstore and zstandard are imported in the tests that use them:
# every xdist worker imports this module when it collects, and they take
# seconds to import.


def bits(x):
    """A leaf as a numpy array whose equality is bit equality (bfloat16 as
    int16, whether a torch tensor or an ml_dtypes array)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def assert_trees_equal(got, want, path=""):
    """Same structure, and each leaf of the same dtype, shape and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}/{i}")
    elif want is None or isinstance(want, (int, float)):
        assert got == want and type(got) is type(want), path
    else:
        g, w = bits(got), bits(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (path, g.dtype,
                                                            w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=path)


# --- zstd --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def payload(size, seed=0):
    """Seeded bytes with the structure zstd exploits: runs of words,
    smooth float32 values and noise."""
    rng = np.random.default_rng(seed)
    words = b" ".join(rng.choice([b"alpha", b"beta", b"gamma", b"delta"],
                                 size // 4 + 1))
    smooth = np.round(np.cumsum(rng.normal(size=size // 4 + 1)) * 4
                      ).astype(np.float32).tobytes()
    noise = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    mixed = b"".join(part[i:i + 4096] for i in range(0, size, 4096)
                     for part in (words, smooth, noise))
    return mixed[:size]


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("size", [0, 1, 1000, 200_000, 3_000_000])
def test_zstd_equals_zstandard(size, level):
    """With and without the content size and the checksum in the
    header."""
    import zstandard
    flags = [(True, True), (True, False), (False, True), (False, False)]
    if size == 3_000_000 and level == 19:
        # Level 19 takes 1.7 s to encode 3 MB: level 12 (0.3 s) writes the
        # same block kinds; two of the four headers.
        level, flags = 12, flags[::3]
    data = payload(size, seed=size + 5)
    for content_size, checksum in flags:
        frame = zstandard.ZstdCompressor(
            level=level, write_content_size=content_size,
            write_checksum=checksum).compress(data)
        assert _native.zstd_decompress(frame) == data
    # A stream written without knowing its size (no content size field).
    stream = zstandard.ZstdCompressor(level=level).compressobj()
    assert _native.zstd_decompress(stream.compress(data) + stream.flush()) \
        == data


def test_zstd_concatenated_and_skippable_frames():
    import zstandard
    a, b = payload(70_000, 1), payload(5_000, 2)
    c = zstandard.ZstdCompressor(level=3)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(
        4, "little") + b"hello"
    frames = c.compress(a) + skippable + c.compress(b) + skippable
    assert _native.zstd_decompress(frames) == zstandard.ZstdDecompressor(
        ).decompressobj().decompress(c.compress(a)) + b
    assert _native.zstd_decompress(frames) == a + b


def test_zstd_refuses_corrupt_input():
    """Truncation anywhere, a flipped bit (the frame has a checksum, so a
    flip either breaks a field or the checksum, or lands on a bit the
    content does not depend on), a dictionary's frame and a foreign magic
    all raise ``ValueError``."""
    import zstandard
    data = payload(150_000, 3)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        data)
    for n in list(range(0, len(frame), 997)) + [len(frame) - 1]:
        with pytest.raises(ValueError):
            _native.zstd_decompress(frame[:n])
    rng = np.random.default_rng(4)
    raised = 0
    for _ in range(200):
        flipped = bytearray(frame)
        flipped[int(rng.integers(len(frame)))] ^= 1 << int(rng.integers(8))
        try:
            assert _native.zstd_decompress(bytes(flipped)) == data
        except ValueError:
            raised += 1
    assert raised >= 190
    samples = [payload(300, s) for s in range(200)]
    dictionary = zstandard.train_dictionary(2048, samples)
    named = zstandard.ZstdCompressor(dict_data=dictionary).compress(
        samples[0])
    with pytest.raises(ValueError, match="dictionary"):
        _native.zstd_decompress(named)
    with pytest.raises(ValueError, match="zstd"):
        _native.zstd_decompress(b"\x00\x01\x02\x03\x04\x05\x06\x07")


# --- OCDBT -------------------------------------------------------------------

def test_ocdbt_refuses_a_corrupt_node(tmp_path):
    """A flipped bit in a node fails its crc32c: ``ValueError``."""
    root = shutil.copytree(os.path.join(FIXTURES, "orbax_small"),
                           str(tmp_path / "tree"))
    (node,) = os.listdir(os.path.join(root, "d"))
    path = os.path.join(root, "d", node)
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 4
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="crc32c"):
        OcdbtStore(root)


def test_ocdbt_store_reads_and_writes_what_tensorstore_does(tmp_path):
    """A tree of three levels of interior nodes, zstd-compressed, with
    inline and indirect values (tensorstore's writer with small nodes),
    read key for key; and the port's writer read back by tensorstore."""
    import tensorstore as ts
    root = str(tmp_path / "deep")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16,
                                     "compression": {"id": "zstd"}}}
                         ).result()
    txn = ts.Transaction()
    want = {f"pre/key{i:03d}/x": b"v%d" % i * (1 + i % 9) for i in range(60)}
    for key, value in want.items():
        kv.with_transaction(txn)[key] = value
    txn.commit_async().result()
    store = OcdbtStore(root)
    assert store.keys() == sorted(want)
    assert {k: store[k] for k in store.keys()} == want

    rng = np.random.default_rng(5)
    items = {f"a/{i}": rng.integers(0, 256, int(rng.integers(0, 3000)),
                                    dtype=np.uint8).tobytes()
             for i in range(40)}
    items["empty"] = b""
    written = str(tmp_path / "written")
    write_ocdbt(written, items)
    theirs = ts.KvStore.open({"driver": "ocdbt",
                              "base": f"file://{written}/"}).result()
    assert {k.decode(): theirs.read(k).result().value
            for k in theirs.list().result()} == items


# --- trees both ways ---------------------------------------------------------

def seeded_stereo(name, seed=1):
    model = build_stereo_model(name, 16)
    init_params(model, seed)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(generator=gen)
                m.running_var.uniform_(0.5, 2.0, generator=gen)
    return model.eval()


def jax_variables(model):
    """A port network's Flax variables as a tree of jax arrays."""
    return jax.tree_util.tree_map(
        jnp.asarray, nest_variables(flax_arrays_from_state_dict(model)))


def seeded_deep3d(seed=4):
    """Deep3D at the down shape (32, 64) with its constructor's weights,
    drawn from ``seed``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return Deep3D((32, 64))


@pytest.mark.parametrize("name", [
    "msnet2d",
    # JAX's save of 409 arrays, about 2.5 s.
    pytest.param("gwcnet", marks=pytest.mark.slow),
    # 78M parameters: JAX's save takes about 5 s, the port's zstd read 3 s.
    pytest.param("deep3d", marks=pytest.mark.slow)])
def test_jax_save_params_loads_in_the_port(tmp_path, name):
    """JAX's ``save_params`` (OCDBT, zstd) -> the port's ``load_params``:
    the same tree, bit for bit; and the port's network loads it."""
    model = seeded_deep3d() if name == "deep3d" else seeded_stereo(name)
    variables = jax_variables(model)
    path = str(tmp_path / name)
    jax_save_params(variables, path)
    want = jax.tree_util.tree_map(np.asarray, variables)
    assert_trees_equal(load_params(path), want)
    if name == "deep3d":
        state, meta = load_deep3d_checkpoint(path)
        assert meta == {}
        loaded = Deep3D((32, 64))
        loaded.load_state_dict(state)
    else:
        loaded = build_stereo_model(name, 16)
        assert load_or_init_params(loaded, name, checkpoint_dir=path) == path
    assert_trees_equal(nest_variables(flax_arrays_from_state_dict(loaded)),
                       want)


def mixed_tree():
    """bf16, int32, int64 and float64 leaves, a list, a scalar and an array
    sharded over two CPU devices (two zarr chunks)."""
    rng = np.random.default_rng(6)
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    return {
        "params": {"w": jnp.asarray(rng.normal(size=(5, 7)), jnp.float32),
                   "scale": jnp.asarray(rng.normal(size=9), jnp.bfloat16)},
        "ids": jnp.asarray(rng.integers(-9, 9, 4), jnp.int32),
        "wide": np.arange(6, dtype=np.int64).reshape(2, 3),
        "double": rng.normal(size=3),
        "lst": [jnp.ones(2), jnp.zeros((1, 2))],
        "sharded": jax.device_put(
            jnp.asarray(rng.normal(size=(6, 4)), jnp.float32),
            NamedSharding(mesh, PartitionSpec("x"))),
        "epoch": 11,
    }


def test_mixed_tree_both_ways(tmp_path):
    """JAX -> port and port -> JAX (with and without a template), each bit
    for bit with what JAX restores, bfloat16 as ``torch.bfloat16``."""
    tree = mixed_tree()
    theirs = str(tmp_path / "jax")
    jax_save_params(tree, theirs)
    want = jax.tree_util.tree_map(np.asarray, jax_load_params(theirs))
    assert read_tree(theirs)["sharded"].shape == (6, 4)
    got = load_params(theirs)
    assert got["params"]["scale"].dtype == torch.bfloat16
    assert_trees_equal(got, want)

    ours = str(tmp_path / "port")
    save_params(got, ours)
    assert_trees_equal(jax.tree_util.tree_map(np.asarray,
                                              jax_load_params(ours)), want)
    template = dict(jax_load_params(theirs),
                    sharded=jnp.zeros((6, 4), jnp.float32))
    assert_trees_equal(jax.tree_util.tree_map(
        np.asarray, jax_load_params(ours, template)), want)
    assert_trees_equal(load_params(ours, template=want), want)


@pytest.mark.parametrize("name", [
    "msnet2d",
    # JAX restores each of its 409 arrays in a few ms, twice.
    pytest.param("gwcnet", marks=pytest.mark.slow)])
def test_port_save_params_loads_in_jax(tmp_path, name):
    """The port's ``save_params`` of a network -> JAX's ``load_params``
    (as its ``load_or_init_params`` calls it) and JAX's
    ``load_or_init_params`` shape check: its variables bit for bit."""
    model = seeded_stereo(name, seed=2)
    path = str(tmp_path / name)
    save_params(model, path)
    want = nest_variables(flax_arrays_from_state_dict(model))
    assert_trees_equal(jax.tree_util.tree_map(np.asarray,
                                              jax_load_params(path)), want)
    if name == "gwcnet":
        template = jax.tree_util.tree_map(jnp.zeros_like,
                                          jax_variables(model))
        assert_trees_equal(jax.tree_util.tree_map(
            np.asarray, jax_load_params(path, template)), want)


# --- the lookup order ----------------------------------------------------------

def test_load_or_init_params_reads_an_orbax_directory(tmp_path):
    """The fault this slice repairs: given an Orbax directory, the port
    loaded the committed ``data/checkpoints/msnet3d.npz`` instead, where
    JAX loads the directory.  Now both take the directory (JAX's order:
    npz file, ``.npz`` appended, Orbax directory), and the port's
    disparity equals JAX's on it within 1e-3 px (the networks'
    contract)."""
    model = seeded_stereo("msnet3d", seed=3)
    path = str(tmp_path / "msnet3d")
    save_params(model, path)
    port = build_stereo_model("msnet3d", 16)
    assert load_or_init_params(port, "msnet3d", checkpoint_dir=path) == path
    jax_model = jax_build_stereo_model("msnet3d", 16)
    # The tree JAX's load_or_init_params returns for the directory (JAX
    # reading the port's trees: test_port_save_params_loads_in_jax).
    variables = jax_variables(model)
    rng = np.random.default_rng(7)
    left, right = (rng.normal(size=(1, 3, 32, 64)).astype(np.float32)
                   for _ in range(2))
    want = np.asarray(jax.jit(lambda v, a, b: jax_model.apply(
        v, a, b, train=False))(variables, left, right))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(left),
                          torch.from_numpy(right)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    # An npz beside the directory comes first, as in JAX.
    shutil.copy(os.path.join(os.path.dirname(__file__), os.pardir, "data",
                             "checkpoints", "msnet3d.npz"), path + ".npz")
    assert load_or_init_params(port, "msnet3d", checkpoint_dir=path) == \
        path + ".npz"


def test_right_view_synthesis_from_an_orbax_directory(tmp_path):
    """A Deep3D Orbax directory (the port's ``save_params``):
    ``RightViewSynthesis`` loads it by ``checkpoint_dir`` to the same
    weights bit for bit; an explicit path in neither form raises."""
    model = seeded_deep3d()
    path = str(tmp_path / "deep3d")
    save_params(model, path)
    loaded = RightViewSynthesis(
        checkpoint_dir=path, output_shape=(48, 96),
        model_full_shape=(128, 256), model_down_shape=(32, 64),
        ff_weights_dtype="float32", device="cpu")
    want = model.state_dict()
    for key, value in loaded.model.state_dict().items():
        assert torch.equal(value, want[key]), key
    with pytest.raises(FileNotFoundError):
        RightViewSynthesis(checkpoint_dir=str(tmp_path / "nowhere"),
                           device="cpu")


@pytest.mark.slow   # Deep3D: JAX's save, both loads, two forwards (~40 s)
def test_right_view_synthesis_from_a_jax_orbax_directory_matches_jax(
        tmp_path):
    """JAX's ``save_params`` of Deep3D variables -> both packages'
    ``RightViewSynthesis(checkpoint_dir=...)``: right views within
    ``test_torch_synthesis.py``'s 2e-3 grey levels (float32 global
    branch)."""
    path = str(tmp_path / "deep3d")
    jax_save_params(jax_variables(seeded_deep3d()), path)
    kwargs = dict(output_shape=(48, 96), model_full_shape=(128, 256),
                  model_down_shape=(32, 64), ff_weights_dtype="float32")
    left = np.random.default_rng(8).uniform(0, 255, (3, 48, 96)).astype(
        np.float32)
    want = np.asarray(JaxRightViewSynthesis(checkpoint_dir=path,
                                            **kwargs).process(left))
    got = RightViewSynthesis(checkpoint_dir=path, device="cpu",
                             **kwargs).process(torch.from_numpy(left))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-3)


# --- training ------------------------------------------------------------------

class TinyNet(torch.nn.Module):
    """A network named as Flax names its layers, standing in for Deep3D
    (78M parameters) in the trainers' Orbax round trips."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = torch.nn.Conv2d(3, 4, 3)
        self.Dense_0 = torch.nn.Linear(6, 5)


def grads_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), tree)


_STEPS = {}


def jax_step(trainer, grads):
    """One optax update of a JAX trainer's state, compiled whole once per
    optimizer (the update's ops one by one compile for seconds)."""
    optimizer = trainer.optimizer
    if id(optimizer) not in _STEPS:
        @jax.jit
        def step(params, opt_state, grads):
            updates, opt_state = optimizer.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state
        _STEPS[id(optimizer)] = (optimizer, step)
    trainer.params, trainer.opt_state = _STEPS[id(optimizer)][1](
        trainer.params, trainer.opt_state, grads)


def port_step(trainer, grads):
    named = state_dict_from_flax(trainer.model, {
        k: np.array(v) for k, v in flatten_variables(
            {"params": grads}).items()})
    for name, p in trainer.model.named_parameters():
        p.grad = named[name].clone()
    trainer.optimizer.step()


def assert_params_close(port_model, jax_params):
    """Within ``test_torch_train_loop.py``'s 2e-6 (float32 updates summed
    in another order)."""
    got = flax_arrays_from_state_dict(port_model)
    for key, value in flatten_variables({"params": jax_params}).items():
        np.testing.assert_allclose(got[key], np.asarray(value), rtol=0,
                                   atol=2e-6, err_msg=key)


def test_deep3d_trainer_checkpoints_resume_both_ways(tmp_path):
    """JAX ``Trainer`` (inject_hyperparams over coupled Adam) -> two steps,
    ``save_checkpoint`` -> the port's ``load_checkpoint``: the moments,
    count, learning rate and epoch carry over, and one more step on each
    side from the same gradients gives the same parameters.  Then the port's
    ``save_checkpoint(format="orbax")`` -> JAX's ``load_checkpoint``, one
    more step each."""
    jcfg = JaxTrainerConfig(learning_rate=1e-2, weight_decay=1e-2)
    cfg = TrainerConfig(learning_rate=1e-2, weight_decay=1e-2)
    port = Trainer(TinyNet(), cfg, seed=1, device="cpu")
    theirs = JaxTrainer(object(), jcfg, variables={
        "params": jax_variables(port.model)["params"]})
    for step in range(2):
        jax_step(theirs, grads_like(theirs.params, step))
    theirs.opt_state.hyperparams["learning_rate"] = jnp.asarray(
        3e-3, jnp.float32)
    theirs.epoch = 5
    path = str(tmp_path / "jax_ckpt")
    theirs.save_checkpoint(path)

    port.load_checkpoint(path)
    assert port.epoch == 5
    assert port.optimizer.param_groups[0]["lr"] == pytest.approx(3e-3)
    assert_params_close(port.model, theirs.params)
    grads = grads_like(theirs.params, 7)
    jax_step(theirs, grads)
    port_step(port, grads)
    assert_params_close(port.model, theirs.params)

    port.epoch = 6
    ours = str(tmp_path / "port_ckpt")
    port.save_checkpoint(ours, format="orbax")
    again = JaxTrainer(object(), jcfg, variables={
        "params": jax_variables(TinyNet())["params"]})
    again.load_checkpoint(ours)
    assert again.epoch == 6 and int(again.opt_state.count) == 3
    grads = grads_like(theirs.params, 8)
    jax_step(again, grads)
    port_step(port, grads)
    assert_params_close(port.model, again.params)


class TinyBnNet(TinyNet):
    """``TinyNet`` with a BatchNorm, standing in for a stereo network."""

    def __init__(self):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(4)
        gen = torch.Generator().manual_seed(9)
        with torch.no_grad():
            self.BatchNorm_0.running_mean.normal_(generator=gen)
            self.BatchNorm_0.running_var.uniform_(0.5, 2.0, generator=gen)


@pytest.mark.parametrize("name", [
    "tiny",
    # MSNet2D's 480 arrays: the optax update alone compiles for seconds.
    pytest.param("msnet2d", marks=pytest.mark.slow)])
def test_stereo_trainer_checkpoints_resume_both_ways(tmp_path, monkeypatch,
                                                     name):
    """JAX ``StereoTrainer`` (adamw; BatchNorm statistics) -> the port's,
    and the port's Orbax checkpoint restored by Orbax into JAX's template
    (the JAX trainer has no ``load_checkpoint``), one step on each side.
    ``tiny`` hands both trainers ``TinyBnNet``'s variables in MSNet2D's
    place."""
    import orbax.checkpoint as ocp
    jcfg = JaxTrainerConfig(learning_rate=1e-2, weight_decay=0.1)
    cfg = TrainerConfig(learning_rate=1e-2, weight_decay=0.1)
    if name == "tiny":
        seed_model = TinyBnNet()
        monkeypatch.setattr(stereo_trainer_module, "build_stereo_model",
                            lambda *_: TinyBnNet())
    else:
        seed_model = seeded_stereo(name, seed=5)
    theirs = JaxStereoTrainer("msnet2d", 16, jcfg,
                              variables=jax_variables(seed_model))
    jax_step(theirs, grads_like(theirs.params, 0))
    theirs.epoch = 2
    path = str(tmp_path / "jax_ckpt")
    theirs.save_checkpoint(path)

    port = StereoTrainer("msnet2d", 16, cfg, device="cpu")
    port.load_checkpoint(path)
    assert port.epoch == 2
    stats = nest_variables(flax_arrays_from_state_dict(port.model))
    assert_trees_equal(stats["batch_stats"], jax.tree_util.tree_map(
        np.asarray, theirs.batch_stats))
    grads = grads_like(theirs.params, 1)
    jax_step(theirs, grads)
    port_step(port, grads)
    assert_params_close(port.model, theirs.params)

    port.epoch = 3
    ours = str(tmp_path / "port_ckpt")
    port.save_checkpoint(ours, format="orbax")
    restored = ocp.StandardCheckpointer().restore(
        ours, {"params": theirs.params, "batch_stats": theirs.batch_stats,
               "opt_state": theirs.opt_state, "epoch": 0})
    assert restored["epoch"] == 3
    assert int(restored["opt_state"][0].count) == 2
    theirs.params, theirs.opt_state = (restored["params"],
                                       restored["opt_state"])
    grads = grads_like(theirs.params, 2)
    jax_step(theirs, grads)
    port_step(port, grads)
    assert_params_close(port.model, theirs.params)


@pytest.mark.slow   # Deep3D's 78M parameters, their moments, twice (~1 min)
def test_export_script_reads_a_jax_training_checkpoint(tmp_path):
    """``python -m stereo_tpu_torch.scripts.export_rvs_model`` on a JAX
    ``Trainer`` checkpoint of Deep3D: an Orbax export (which JAX's
    ``load_params`` reads as the checkpoint's params) and an npz one, both
    loaded by ``RightViewSynthesis`` (the npz one in float16, the committed
    format)."""
    model = Deep3D()
    init_deep3d_params(model, seed=6)
    theirs = JaxTrainer(object(), JaxTrainerConfig(), variables={
        "params": jax_variables(model)["params"]})
    theirs.epoch = 4
    ckpt = str(tmp_path / "ckpt")
    theirs.save_checkpoint(ckpt)
    for out in (str(tmp_path / "export"), str(tmp_path / "export.npz")):
        export_rvs_model.main(["--checkpoint", ckpt, "--export-dir", out,
                               "--device", "cpu"])
        rvs = RightViewSynthesis(checkpoint_dir=out, device="cpu",
                                 ff_weights_dtype="float32")
        for key, value in model.state_dict().items():
            if out.endswith(".npz"):    # the committed format: float16
                value = value.half().float()
            assert torch.equal(rvs.model.state_dict()[key], value), key
    assert_trees_equal(jax.tree_util.tree_map(np.asarray, jax_load_params(
        str(tmp_path / "export"))), nest_variables(
            flax_arrays_from_state_dict(model)))


# --- refused formats and the fixture -----------------------------------------

def test_zarr3_and_msgpack_trees_raise(tmp_path):
    """A zarr3 tree is read as it was saved; a pre-OCDBT msgpack tree
    raises, naming the route to convert it."""
    import orbax.checkpoint as ocp
    tree = {"w": jnp.arange(4.0)}
    zarr3 = str(tmp_path / "zarr3")
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)) as c:
        c.save(zarr3, tree)
    assert_trees_equal(load_params(zarr3),
                       {"w": np.arange(4.0, dtype=np.float32)})
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    from flax import serialization
    (legacy / "checkpoint").write_bytes(serialization.to_bytes(tree))
    with pytest.raises(ValueError, match="msgpack.*save_params_npz"):
        load_params(str(legacy))


def save_zarr3(tree, path, ocdbt=True):
    import orbax.checkpoint as ocp
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(
            use_ocdbt=ocdbt, use_zarr3=True)) as c:
        c.save(path, tree)
    return path


@pytest.mark.parametrize("ocdbt", [True, False])
def test_zarr3_tree_reads(tmp_path, ocdbt):
    """A tree written with ``use_zarr3=True``, in OCDBT or as plain files
    (``<name>/zarr.json``, chunks under ``c/``): float32, bfloat16, int32,
    int64, float64, nested lists and dicts, a scalar and an array sharded
    over two devices (two chunks), read bit for bit as JAX restores it."""
    path = save_zarr3(mixed_tree(), str(tmp_path / "zarr3"), ocdbt)
    assert json.load(open(os.path.join(path, "_METADATA")))["use_zarr3"]
    assert os.path.exists(os.path.join(path, "manifest.ocdbt")) == ocdbt
    if not ocdbt:
        assert sorted(os.listdir(os.path.join(path, "sharded", "c"))) == [
            "0", "1"]
    want = jax.tree_util.tree_map(np.asarray, jax_load_params(path))
    got = load_params(path)
    assert got["params"]["scale"].dtype == torch.bfloat16
    assert_trees_equal(got, want)


# zarr v3 arrays that tensorstore writes with codecs Orbax does not pick:
# name -> (array, data type, chunk shape, codecs, fill value, key encoding).
_BYTES_LE = {"name": "bytes", "configuration": {"endian": "little"}}
_INDEX = [_BYTES_LE, {"name": "crc32c"}]
_RNG = np.random.default_rng(21)
_PATCHY = _RNG.normal(size=(6, 10)).astype(np.float32)
_PATCHY[:3, :5] = 7.5         # one inner chunk all fill: not stored
ZARR3_ARRAYS = {
    "transpose_big_endian_gzip": (
        _RNG.normal(size=(6, 10)).astype(np.float32), "float32", [4, 4],
        [{"name": "transpose", "configuration": {"order": [1, 0]}},
         {"name": "bytes", "configuration": {"endian": "big"}},
         {"name": "gzip", "configuration": {"level": 5}}], None, None),
    "index_at_start_empty_inner_chunk": (
        _PATCHY, "float32", [6, 10],
        [{"name": "sharding_indexed", "configuration": {
            "chunk_shape": [3, 5], "codecs": [_BYTES_LE, {
                "name": "zstd", "configuration": {"level": 1}}],
            "index_codecs": _INDEX, "index_location": "start"}}], 7.5,
        None),
    "v2_keys_int64": (np.arange(30, dtype=np.int64).reshape(5, 6), "int64",
                      [4, 4], [_BYTES_LE], None,
                      {"name": "v2", "configuration": {"separator": "."}}),
    "bfloat16_fill": (
        np.full((4, 4), 2.5, np.float32), "bfloat16", [2, 2],
        [{"name": "sharding_indexed", "configuration": {
            "chunk_shape": [1, 2], "codecs": [_BYTES_LE],
            "index_codecs": _INDEX}}], 2.5, None),
    "bool_crc32c": (np.arange(7) % 3 == 0, "bool", [3],
                    [_BYTES_LE, {"name": "crc32c"}], None, None),
    "uint8_gzip": (np.arange(50, dtype=np.uint8).reshape(5, 10), "uint8",
                   [2, 8], [{"name": "bytes"}, {
                       "name": "gzip", "configuration": {"level": 1}}],
                   None, None),
}


def ts_write_zarr3(path, arr, dtype, chunks, codecs, fill=None,
                   encoding=None):
    """A zarr v3 array at ``path`` (plain files) written by tensorstore."""
    import tensorstore as ts
    meta = {"shape": list(arr.shape), "data_type": dtype,
            "chunk_grid": {"name": "regular",
                           "configuration": {"chunk_shape": chunks}},
            "codecs": codecs}
    if fill is not None:
        meta["fill_value"] = fill
    if encoding is not None:
        meta["chunk_key_encoding"] = encoding
    shutil.rmtree(path, ignore_errors=True)
    ts.open({"driver": "zarr3", "kvstore": {"driver": "file", "path": path},
             "metadata": meta}, create=True).result().write(
        arr.astype(jnp.bfloat16) if dtype == "bfloat16" else arr).result()


@pytest.mark.parametrize("name", sorted(ZARR3_ARRAYS))
def test_zarr3_codecs(tmp_path, name):
    """A plain-file zarr3 tree whose array tensorstore rewrote with other
    codecs (transpose, big-endian bytes, gzip, crc32c, a shard index at
    the start with an inner chunk left at the fill value, the ``v2`` key
    encoding, several chunks) reads bit for bit."""
    arr, dtype, chunks, codecs, fill, encoding = ZARR3_ARRAYS[name]
    path = save_zarr3({"a": {"b": np.zeros(arr.shape, np.float32)}},
                      str(tmp_path / "tree"), ocdbt=False)
    ts_write_zarr3(os.path.join(path, "a.b"), arr, dtype, chunks, codecs,
                   fill, encoding)
    got = read_tree(path)["a"]["b"]
    if dtype == "bfloat16":
        want = torch.from_numpy(arr).to(torch.bfloat16)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    else:
        assert_trees_equal(got, arr)


def test_zarr3_other_codec_or_bad_checksum_raises(tmp_path):
    """A codec the reader does not take raises, naming it; a shard index
    whose crc32c does not match raises."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    path = save_zarr3({"w": arr}, str(tmp_path / "tree"), ocdbt=False)
    assert_trees_equal(read_tree(path)["w"], arr)
    chunk = os.path.join(path, "w", "c", "0", "0")
    raw = bytearray(open(chunk, "rb").read())
    raw[-5] ^= 1                  # a bit of the index, under its checksum
    open(chunk, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        read_tree(path)
    ts_write_zarr3(os.path.join(path, "w"), arr, "float32", [3, 4],
                   [_BYTES_LE, {"name": "blosc", "configuration": {
                       "cname": "lz4", "clevel": 5, "shuffle": "shuffle",
                       "typesize": 4, "blocksize": 0}}])
    with pytest.raises(ValueError, match="'blosc'"):
        read_tree(path)


def test_load_params_reads_a_zarr3_gwcnet_tree(tmp_path):
    """GwcNet's committed variables saved by Orbax as zarr3: the port's
    ``load_params`` gives the committed npz's tree."""
    want = jax.tree_util.tree_map(np.asarray, load_params_npz(
        model_checkpoint_dir("gwcnet") + ".npz"))
    path = save_zarr3(jax.tree_util.tree_map(jnp.asarray, want),
                      str(tmp_path / "gwcnet"))
    assert_trees_equal(load_params(path), want)


@pytest.mark.parametrize("compressor", ["zstd", "zlib", "gzip", None])
def test_plain_zarr_tree_reads(tmp_path, compressor):
    """A tree written with ``use_ocdbt=False``: the zarr keys as files;
    its chunks re-encoded with each compressor zarr names (zlib and gzip
    through the native runtime's zlib)."""
    import orbax.checkpoint as ocp
    import zstandard
    tree = mixed_tree()
    path = str(tmp_path / "plain")
    with ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)) as c:
        c.save(path, tree)
    assert not os.path.exists(os.path.join(path, "manifest.ocdbt"))
    want = jax.tree_util.tree_map(np.asarray, jax_load_params(path))
    if compressor != "zstd":
        encode = {"zlib": zlib.compress, "gzip": gzip.compress,
                  None: lambda b: b}[compressor]
        for name in ("params.w", "sharded"):
            meta_path = os.path.join(path, name, ".zarray")
            meta = json.load(open(meta_path))
            for chunk in os.listdir(os.path.join(path, name)):
                if chunk != ".zarray":
                    chunk_path = os.path.join(path, name, chunk)
                    raw = zstandard.ZstdDecompressor().decompressobj(
                    ).decompress(open(chunk_path, "rb").read())
                    open(chunk_path, "wb").write(encode(raw))
            meta["compressor"] = compressor and {"id": compressor,
                                                 "level": 1}
            json.dump(meta, open(meta_path, "w"))
    assert_trees_equal(load_params(path), want)


def test_inflate_refuses_a_truncated_stream():
    data = payload(50_000, 9)
    assert _native.inflate(zlib.compress(data)) == data
    assert _native.inflate(gzip.compress(data)) == data
    with pytest.raises(ValueError, match="inflate"):
        _native.inflate(zlib.compress(data)[:-9])


def dotted_leaves(tree, prefix=""):
    """A tree's leaves keyed by their dotted paths, as the twin keys them."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        return {k: v for key, sub in items for k, v in dotted_leaves(
            sub, f"{prefix}{key}.").items()}
    return {prefix[:-1]: tree}


def fixture_twin():
    with np.load(os.path.join(FIXTURES, "orbax_small.npz")) as data:
        bf16 = set(data["__bfloat16__"].tolist())
        return {k: (torch.from_numpy(data[k].view(np.int16)).view(
            torch.bfloat16) if k in bf16 else data[k])
            for k in data.files if k != "__bfloat16__"}


@pytest.mark.parametrize("layout", ["as_saved", "process_trees_only"])
def test_committed_zarr3_fixture_equals_its_twin(tmp_path, layout):
    """``tests/fixtures/orbax_small_zarr3`` (the fixture's tree written
    with ``use_zarr3=True``) read by the port equals the same twin; also
    from the per-process tree alone."""
    root = os.path.join(FIXTURES, "orbax_small_zarr3")
    if layout == "process_trees_only":
        root = shutil.copytree(root, str(tmp_path / "orbax_small_zarr3"))
        os.remove(os.path.join(root, "manifest.ocdbt"))
        shutil.rmtree(os.path.join(root, "d"))
    flat = dotted_leaves(read_tree(root))
    twin = fixture_twin()
    assert set(flat) == set(twin)
    for key, want in twin.items():
        if key == "epoch":
            assert flat[key] == int(want)
        else:
            assert_trees_equal(flat[key], want, key)


@pytest.mark.parametrize("layout", ["as_saved", "process_trees_only"])
def test_committed_fixture_equals_its_twin(tmp_path, layout):
    """``tests/fixtures/orbax_small`` (JAX's ``save_params``: zstd across
    128 KiB blocks, two chunks of a sharded array) read by the port; also
    without its top-level tree, from the per-process ones alone."""
    root = os.path.join(FIXTURES, "orbax_small")
    if layout == "process_trees_only":
        root = shutil.copytree(root, str(tmp_path / "orbax_small"))
        os.remove(os.path.join(root, "manifest.ocdbt"))
        shutil.rmtree(os.path.join(root, "d"))
    flat = dotted_leaves(read_tree(root))
    twin = fixture_twin()
    assert set(flat) == set(twin)
    for key, want in twin.items():
        if key == "epoch":
            assert flat[key] == int(want)
        else:
            assert_trees_equal(flat[key], want, key)
    assert twin["smooth"].nbytes == 1 << 20
