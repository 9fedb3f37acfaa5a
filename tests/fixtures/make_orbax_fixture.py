"""Write the committed Orbax fixture and its npz twin (run from the repo's
root on a machine with JAX and Orbax; it needs two CPU devices, which it
asks XLA for itself)::

    python tests/fixtures/make_orbax_fixture.py

``tests/fixtures/orbax_small/`` is written by ``stereo_tpu.models.save_params``
(Orbax's ``StandardCheckpointer``: OCDBT, zstd) from a seeded tree with
float32, bfloat16 and int32 leaves, a list, a scalar, one float32 array
sharded over the two devices (two zarr chunks) and one smooth float32
array of 1 MiB (its zstd frame spans eight 128 KiB blocks, Huffman
literals and FSE sequences).  ``tests/fixtures/orbax_small.npz`` holds the
same leaves keyed by their dotted paths, bfloat16 as its uint16 bits (the
keys listed under ``__bfloat16__``).  The port reads the tree without JAX
and must equal the twin bit for bit (``tests/test_torch_orbax.py``,
``chip_smoke.py``'s phase ``orbax``).
"""

import os
import shutil
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from stereo_tpu.models import save_params  # noqa: E402

TREE_DIR = os.path.join(HERE, "orbax_small")
TWIN = os.path.join(HERE, "orbax_small.npz")


def seeded_tree():
    """The tree as numpy arrays (bfloat16 through ml_dtypes), a list and a
    Python scalar."""
    rng = np.random.default_rng(15)
    walk = np.cumsum(rng.normal(size=1 << 18))
    smooth = np.round(np.convolve(walk, np.ones(256) / 256, "same") * 4) / 4
    return {
        "params": {
            "conv": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(
                np.float32), "bias": rng.normal(size=8).astype(np.float32)},
            "norm": {"scale": rng.normal(size=16).astype(jnp.bfloat16)}},
        "counts": rng.integers(-1000, 1000, 6).astype(np.int32),
        "sharded": rng.normal(size=(4, 6)).astype(np.float32),
        "smooth": smooth.astype(np.float32),
        "lst": [rng.normal(size=3).astype(np.float32)],
        "epoch": 3,
    }


def main() -> None:
    tree = seeded_tree()
    mesh = Mesh(np.array(jax.devices()[:2]), ("x",))
    as_jax = jax.tree_util.tree_map(jnp.asarray, tree)
    as_jax["epoch"] = tree["epoch"]                # an Orbax "scalar"
    as_jax["sharded"] = jax.device_put(
        tree["sharded"], NamedSharding(mesh, PartitionSpec("x")))
    shutil.rmtree(TREE_DIR, ignore_errors=True)
    save_params(as_jax, TREE_DIR)

    twin, bf16 = {}, []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        arr = np.asarray(leaf)
        if arr.dtype == jnp.bfloat16:
            arr = arr.view(np.uint16)
            bf16.append(name)
        twin[name] = arr
    np.savez_compressed(TWIN, __bfloat16__=np.array(bf16), **twin)
    for root, _, files in os.walk(TREE_DIR):
        for f in files:
            size = os.path.getsize(os.path.join(root, f))
            assert size < 256 * 1024, (f, size)
    print(f"wrote {TREE_DIR} and {TWIN}")


if __name__ == "__main__":
    main()
