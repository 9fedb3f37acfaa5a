"""Eager row-split ms/frame of one tree's port on the card, to compare two
trees in one chip call: ``python tests/torch_eager_split_ab.py ROOT
LABEL`` imports ``stereo_tpu_torch`` from ``ROOT`` and prints one JSON
line, ``LABEL`` and the median ms/frame (10 frames after 3 warm-up
calls, 384x1280, seeded inputs, the committed weights under ROOT) of
MSNet2D on (1,4,1), GwcNet on (1,4,1) and MSNet2D on (1,2,1), virtual
meshes of cuda:0, with ``graph_splits`` off.  Alternate the trees
(parent, change, change, parent) in one command."""
import json
import statistics
import sys
import time

root, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, root)
import numpy as np  # noqa: E402
import torch  # noqa: E402
from stereo_tpu_torch.core.config import MeshConfig  # noqa: E402
from stereo_tpu_torch.parallel import ShardedDnnEngine, make_mesh  # noqa: E402

dev = torch.device("cuda", 0)
out = {"label": label}
for name, tile in (("msnet2d", 4), ("gwcnet", 4), ("msnet2d", 2)):
    mc = MeshConfig(1, tile, 1)
    engine = ShardedDnnEngine(name, (384, 1280), mc,
                              mesh=make_mesh(mc, [dev] * tile),
                              max_disparity=64)
    engine.graph_splits = False
    rng = np.random.default_rng(0)
    left = torch.from_numpy(rng.uniform(0, 255, (1, 3, 384, 1280)).astype(
        np.float32)).to(dev)
    right = torch.roll(left, -7, dims=-1)
    for _ in range(3):
        engine.process_batch(left, right)
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.process_batch(left, right)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out[f"{name}_{tile}"] = statistics.median(times)
    del engine
print(json.dumps(out), flush=True)
