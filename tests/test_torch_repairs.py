"""The port against the reference where they once differed: the stage
timer's memory on CUDA, the model-loading call forms, and the stage times
and log lines of a stereo-pair frame."""

import re

import numpy as np
import pytest
import torch

from stereo_tpu.core.config import PipelineConfig as JaxPipelineConfig
from stereo_tpu.pipeline.depth_pipeline import (
    DepthEstimationPipeline as JaxPipeline)

from stereo_tpu_torch.core.config import PipelineConfig
from stereo_tpu_torch.models import (build_stereo_model, init_params,
                                     init_stereo_params, load_or_init_params)
from stereo_tpu_torch.pipeline import DepthEstimationPipeline
from stereo_tpu_torch.utils import paths
from stereo_tpu_torch.utils.profiling import StageTimer

import torch_threads

torch_threads.take_worker_share()

STAGE_MS = {"right_view_generation": 4.0, "stereo_matching": 2.5}


def fake_event_class(done: bool):
    """Stands for ``torch.cuda.Event``: ``query()`` is ``done``; an end
    event recorded in stage ``name`` is ``STAGE_MS[name]`` after its
    start."""

    class FakeEvent:
        current = None

        def __init__(self, enable_timing=False):
            self.stage = FakeEvent.current

        def record(self):
            pass

        def query(self):
            return done

        def elapsed_time(self, end):
            return STAGE_MS[end.stage]

    return FakeEvent


def run_stages(monkeypatch, done: bool, frames: int):
    event = fake_event_class(done)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    timer = StageTimer(torch.device("cuda"))
    most_pending = 0
    for i in range(frames):
        name = ("right_view_generation", "stereo_matching")[i % 2]
        event.current = name
        with timer.stage(name):
            pass
        most_pending = max(most_pending, timer.pending)
    return timer, most_pending


def test_stage_timer_folds_completed_events(monkeypatch):
    timer, most_pending = run_stages(monkeypatch, done=True, frames=1000)
    assert most_pending <= 2
    drained, most_waiting = run_stages(monkeypatch, done=False, frames=1000)
    assert most_waiting == 1000      # nothing completes: all wait for summary
    means = timer.summary()
    assert means == drained.summary()
    assert means == pytest.approx({k: ms / 1000.0
                                   for k, ms in STAGE_MS.items()})
    assert timer.pending == drained.pending == 0


@pytest.mark.parametrize("name", ["gwcnet", "msnet2d", "msnet3d"])
def test_reference_call_form_loads_the_committed_checkpoint(name):
    npz = paths.model_checkpoint_dir(name) + ".npz"
    models = [build_stereo_model(name, max_disparity=64) for _ in range(3)]
    # The reference's form (shape tuple third) and the port's two forms.
    assert load_or_init_params(models[0], name, (64, 256)) == npz
    assert load_or_init_params(models[1], name) == npz
    assert load_or_init_params(models[2], name, checkpoint_dir=npz) == npz
    a, b, c = (m.state_dict() for m in models)
    assert all(torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])
               for k in a)


def test_init_stereo_params_is_the_seeded_init():
    models = [build_stereo_model("msnet3d", 64) for _ in range(2)]
    assert init_stereo_params(models[0], (384, 1280), seed=5) is None
    init_params(models[1], 5)
    a, b = (m.state_dict() for m in models)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_stereo_pair_stages_and_log_lines_match_reference(capsys):
    shape, max_d = (32, 96), 8
    rng = np.random.default_rng(4)
    left = np.round(rng.uniform(0, 255, (3, *shape))).astype(np.float32)
    right = np.roll(left, -3, axis=-1)

    def lines(make_pipeline):
        capsys.readouterr()
        pipe = make_pipeline()
        for _ in range(2):
            np.asarray(pipe.process(left, right).disparity_map)
        out = capsys.readouterr().out
        return pipe, re.sub(r"\d+\.\d+ seconds", "T seconds", out).splitlines()

    jax_pipe, want = lines(lambda: JaxPipeline(JaxPipelineConfig(
        image_shape=shape, max_disparity=max_d, log_perf_time=True)))
    pipe, got = lines(lambda: DepthEstimationPipeline(PipelineConfig(
        image_shape=shape, max_disparity=max_d, log_perf_time=True),
        device="cpu"))
    assert got == want
    assert want == ["Using 'classical' as stereo matching backend."] + [
        "[Right view generation]: T seconds",
        "[Stereo matching]: T seconds"] * 2
    # A fresh pipeline that saw only pairs has both stages, as JAX's does.
    assert set(pipe.stage_times()) == set(jax_pipe.stage_times()) == {
        "right_view_generation", "stereo_matching"}
