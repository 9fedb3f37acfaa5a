"""JAX's GSPMD training step of ``__graft_entry__.dryrun_multichip`` (b)
against JAX's own unsharded step, on the CPU's virtual devices:

    JAX_PLATFORMS=cpu python tests/jax_gspmd_train_check.py

For each mesh (the graft entry's shardings: batch over ``data`` x
``disp``, rows over ``tile``) and view size, Deep3D's value and gradient
(dropout off, the unfused ``synthesize_with_probabilities``, the
deconvolution branches 16 filters wide, seeded weights and views) under
``jax.jit(..., in_shardings=...)`` and under a plain ``jax.jit``: prints
one JSON line per case with the loss gap and the array whose largest
entry differs most, as the ratio of the sharded to the unsharded largest
entry.  It names the cases where JAX's partitioned gradient is not its
own unsharded one (``tests/test_torch_mesh_train.py`` compares the port
with JAX's GSPMD step only where they agree).  About 5 minutes.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import conftest  # noqa: E402,F401  (8 virtual CPU devices)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from stereo_tpu.core.config import MeshConfig  # noqa: E402
from stereo_tpu.models import Deep3D  # noqa: E402
from stereo_tpu.parallel import make_mesh  # noqa: E402
from test_torch_train_models import flat, nest  # noqa: E402

from stereo_tpu_torch.models import (Deep3D as PortDeep3D,  # noqa: E402
                                     flax_arrays_from_state_dict,
                                     init_deep3d_params)

FILTERS = (16, 16, 16, 16, 16)
# (full view, batch, meshes)
CASES = [((128, 128), 2, [(2, 1, 1), (1, 2, 1), (2, 2, 1), (1, 2, 2),
                          (1, 4, 1)]),
         ((128, 128), 4, [(4, 1, 1), (2, 1, 2), (2, 2, 1), (4, 2, 1)]),
         ((128, 256), 2, [(2, 2, 1), (1, 4, 1)]),
         ((256, 256), 2, [(1, 2, 1), (2, 2, 1)])]


def main():
    model = Deep3D(deconv_filters=FILTERS)

    def loss_fn(p, lf, ld, rf):
        pred = model.apply({"params": p}, lf, ld, train=False,
                           method=Deep3D.synthesize_with_probabilities)[0]
        return jnp.abs(pred - rf).mean()

    for full, n, meshes in CASES:
        port = PortDeep3D((full[0] // 4, full[1] // 4), deconv_filters=FILTERS)
        init_deep3d_params(port, 0)
        params = nest(flax_arrays_from_state_dict(port))["params"]
        rng = np.random.default_rng(0)
        left = rng.uniform(0, 1, (n, 3, *full)).astype(np.float32)
        right = rng.uniform(0, 1, (n, 3, *full)).astype(np.float32)
        down = torch.nn.functional.avg_pool2d(torch.from_numpy(left),
                                              4).numpy()
        loss0, grads0 = jax.jit(jax.value_and_grad(loss_fn))(
            params, left, down, right)
        grads0 = flat({"params": grads0})
        for shape in meshes:
            mesh = make_mesh(MeshConfig(*shape),
                             jax.devices()[:int(np.prod(shape))])
            batch = NamedSharding(mesh, P(("data", "disp"), None, "tile",
                                          None))
            loss, grads = jax.jit(jax.value_and_grad(loss_fn), in_shardings=(
                NamedSharding(mesh, P()), batch, batch, batch))(
                    params, left, down, right)
            grads = flat({"params": grads})
            gap, key = max(
                (float(np.abs(grads[k] - grads0[k]).max()
                       / np.abs(grads0[k]).max()), k) for k in grads0)
            print(json.dumps(dict(
                full=list(full), batch=n, mesh=list(shape),
                loss_rel_gap=abs(float(loss) - float(loss0)) / float(loss0),
                worst_array=key, worst_rel_gap=gap,
                max_ratio=float(np.abs(grads[key]).max()
                                / np.abs(grads0[key]).max()))), flush=True)


if __name__ == "__main__":
    main()
