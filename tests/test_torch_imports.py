"""The port stands alone: no module of ``stereo_tpu_torch`` and not
``chip_smoke.py`` imports JAX, Flax, optax, PIL, OpenCV, ``stereo_tpu``,
Orbax, tensorstore or zstandard (the card's machine has none of them), and
its entry points never fall back to the CPU on their own."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

import torch_threads

torch_threads.take_worker_share()

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "stereo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "PIL", "cv2", "stereo_tpu",
             "orbax", "tensorstore", "zstandard")
# The port, the smoke and its I/O module, the file writers the smoke
# imports, and the ranks the multi-process tests spawn.
SOURCES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_smoke_io.py",
    ROOT / "tests" / "raster_files.py",
    ROOT / "tests" / "torch_multiprocess_ranks.py",
    ROOT / "tests" / "torch_spawn_targets.py"]


def imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import(path):
    assert not imported_roots(path) & set(FORBIDDEN)


_BLOCKED_RUN = """
import importlib, pkgutil, sys
for name in {forbidden!r}:
    sys.modules[name] = None          # any import of it now fails
import numpy as np
import stereo_tpu_torch
for mod in pkgutil.walk_packages(stereo_tpu_torch.__path__, "stereo_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
import chip_smoke_io
from stereo_tpu_torch.core.config import MatchingConfig
from stereo_tpu_torch.matching.classical import ClassicalStereoEngine
rng = np.random.default_rng(0)
left = rng.integers(0, 256, (3, 32, 64)).astype(np.float32)
engine = ClassicalStereoEngine(MatchingConfig(height=32, width=64,
    min_disparity=0, max_disparity=15), device="cpu")
disp = engine.compute_disparity_map(left, np.roll(left, -4, axis=-1))
assert disp.shape == (32, 64)
print("median", float(disp[:, 8:-8].median()))
import torch
from stereo_tpu_torch.models import build_stereo_model, init_params
from stereo_tpu_torch.ops.cuda import build
from stereo_tpu_torch import _native
for name in ("gwcnet", "msnet2d", "msnet3d"):
    net = build_stereo_model(name, 32)
    init_params(net, 0)
    with torch.no_grad():
        out = net.eval()(torch.zeros(1, 3, 32, 64), torch.zeros(1, 3, 32, 64))
    print(name, tuple(out.shape))
assert build._library is None        # importing and running built nothing
assert _native._library is None
"""


def test_port_runs_with_forbidden_modules_blocked():
    code = _BLOCKED_RUN.format(forbidden=FORBIDDEN)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "median 4.0" in proc.stdout
    for name in ("gwcnet", "msnet2d", "msnet3d"):
        assert f"{name} (1, 32, 64)" in proc.stdout


def test_entry_points_without_device_raise_when_cuda_is_absent(monkeypatch):
    from stereo_tpu_torch.core.config import MatchingConfig, PipelineConfig
    from stereo_tpu_torch.matching.classical import ClassicalStereoEngine
    from stereo_tpu_torch.pipeline import (DepthEstimationPipeline,
                                           DnnStereoMatchingBackend)
    from stereo_tpu_torch.serve import DepthEstimationServer
    from stereo_tpu_torch.synthesis import RightViewSynthesis

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: ClassicalStereoEngine(MatchingConfig()),
                  lambda: DepthEstimationPipeline(PipelineConfig()),
                  lambda: DnnStereoMatchingBackend("gwcnet", (64, 128)),
                  lambda: RightViewSynthesis(seed=0),
                  lambda: DepthEstimationServer(PipelineConfig())):
        with pytest.raises(RuntimeError, match="is_available"):
            build()
    engine = ClassicalStereoEngine(MatchingConfig(), device="cpu")
    assert engine.device == torch.device("cpu")


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No CUDA device, or no repository beside the script: exit non-zero
    and print no result."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


PARALLEL_MODULES = ("mesh", "classical", "dnn", "synthesis", "health",
                    "transport", "train")


@pytest.mark.parametrize("name", PARALLEL_MODULES)
def test_parallel_module_stands_alone(name):
    """Each module of the mesh package exists and imports none of JAX,
    Flax or ``stereo_tpu`` (the blocked run above imports them all)."""
    path = PORT / "parallel" / f"{name}.py"
    assert path in SOURCES
    assert not imported_roots(path) & set(FORBIDDEN)


def test_parallel_exports_what_the_jax_package_exports(monkeypatch):
    import stereo_tpu.parallel as jax_parallel
    import stereo_tpu_torch.parallel as parallel
    from stereo_tpu_torch.core.config import MeshConfig, PipelineConfig
    from stereo_tpu_torch.parallel import make_mesh
    from stereo_tpu_torch.pipeline import DepthEstimationPipeline

    assert sorted(parallel.__all__) == sorted(jax_parallel.__all__)
    assert all(hasattr(parallel, name) for name in parallel.__all__)
    # Without a card the default mesh and a mesh pipeline raise.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="wants 2 devices"):
        make_mesh(MeshConfig(data=2))
    with pytest.raises(RuntimeError, match="is_available"):
        DepthEstimationPipeline(PipelineConfig(mesh=MeshConfig(data=2)))
