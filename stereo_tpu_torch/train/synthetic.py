"""Procedural stereo scenes, and the trainers that learn on them (port of
``stereo_tpu/train/synthetic.py``).

A scene is a stack of fronto-parallel textured layers (a background and
rectangles), painted far to near so that occlusions agree in both views.
Each layer has one disparity ``d`` and a closed-form texture ``T(x, yw)``
(sinusoid gratings plus a shader-hash noise term) at world columns ``yw``:
the right view samples ``T(x, y)``, the left ``T(x, y - d)``, so
``right[y] = left[y + d]``.  The ground truth is painted in left-frame
coordinates in the same order.

The generator draws with ``train.prng``, the JAX package's key stream
(threefry2x32, partitionable), in the JAX module's key layout, so a key
gives the JAX package's scene.  Key and scalar arithmetic runs where the
key lies (the CPU is cheapest: a few thousand tiny integer ops a scene);
images are made on ``device``.  Where XLA fuses a product and a sum into
one FMA on the CPU, the generator rounds once too (``prng.fma32``), and
the hash noise takes its sine in float64: it multiplies the sine by 43758,
so the last bit of the sine decides a grey level or more.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import torch

from . import prng

_N_GRATINGS = 6


def _grid(height: int, width: int, device):
    x = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    y = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    return x.expand(height, width), y.expand(height, width)


def _f32(v) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def _col(v: torch.Tensor, device) -> torch.Tensor:
    """Per-scene scalars (B,) -> (B, 1, 1) on ``device``."""
    return v.to(device)[:, None, None]


def _texture_params(keys: torch.Tensor):
    """The five draws of one layer texture, per key (B, 2)."""
    kb, kf, kp, ka, kg = prng.split(keys, 5).unbind(-2)
    base = prng.uniform(kb, (3, 1, 1), 60.0, 195.0)
    period_log2 = prng.uniform(kf, (_N_GRATINGS,), 2.0, 7.0)
    angle = prng.uniform(kp, (_N_GRATINGS,), 0.0, 2.0 * math.pi)
    phase = prng.uniform(ka, (_N_GRATINGS,), 0.0, 2.0 * math.pi)
    gains = prng.uniform(kg, (3, _N_GRATINGS), -28.0, 28.0)
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32)
    freq = (two_pi.double() / torch.exp2(period_log2.double())).float()
    fx = (freq.double() * torch.sin(angle.double())).float()
    fy = (freq.double() * torch.cos(angle.double())).float()
    return base, fx, fy, phase, gains


def _layer_texture(params, x_hw: torch.Tensor, yw: torch.Tensor
                   ) -> torch.Tensor:
    """Texture at world coordinates: x (H, W), yw (B, H, W) -> (B, 3, H,
    W) in 0..255."""
    base, fx, fy, phase, gains = (p.to(yw.device) for p in params)
    img = base.expand(-1, 3, *yw.shape[1:]).clone()
    waves = []
    for g in range(_N_GRATINGS):
        arg = (fx[:, g, None, None] * x_hw + fy[:, g, None, None] * yw
               + phase[:, g, None, None])
        waves.append(torch.sin(arg))
    summed = sum(gains[:, :, g, None, None] * waves[g][:, None]
                 for g in range(_N_GRATINGS))
    img = img + summed
    arg = prng.fma32(yw, torch.tensor(78.233, device=yw.device),
                     x_hw * torch.tensor(12.9898, device=yw.device))
    hash_val = (torch.sin(arg.double()).float()
                * torch.tensor(43758.5453, device=yw.device))
    noise = (hash_val - torch.floor(hash_val)) - 0.5
    img = prng.fma32(torch.tensor(14.0, device=yw.device), noise[:, None],
                     img)
    return img.clamp(0.0, 255.0)


def _shifted(y_hw: torch.Tensor, t: torch.Tensor, d: torch.Tensor
             ) -> torch.Tensor:
    """World columns ``y + t * d``."""
    return y_hw + t * d


def synthetic_stereo_scenes(keys: torch.Tensor, height: int, width: int,
                            min_disparity: float = 6.0,
                            max_disparity: float = 58.0, n_layers: int = 6,
                            depth_prior: bool = False,
                            with_right_frame_gt: bool = False,
                            camera_t: float = 0.0, device=None):
    """One scene per key, keys (B, 2) -> ``(left (B, 3, H, W), right,
    gt (B, H, W))`` float32 on ``device`` (default: the keys' device),
    plus ``gt_right`` with ``with_right_frame_gt``.  The scene of key k is
    ``stereo_tpu.train.synthetic.synthetic_stereo_scene(k, ...)``."""
    device = torch.device(device) if device is not None else keys.device
    b = keys.shape[0]
    x_hw, y_hw = _grid(height, width, device)
    kd, kbg, klayers = prng.split(keys, 3).unbind(-2)

    if depth_prior:
        # A ground ramp far (top) to near (bottom), in float32 as the JAX
        # camera computes it; the division is XLA's multiply by 1/(H-1).
        lo, hi = _f32(min_disparity), _f32(max_disparity)
        near = lo + (hi - lo) * 0.55
        recip = _f32(1.0) / max(height - 1, 1)
        r = ((x_hw[:, :1] * recip.to(device)).double() ** 1.5).float()
        d_bg_row = lo.to(device) + (near - lo).to(device) * r
        d_bg = d_bg_row.expand(height, width)[None].expand(b, -1, -1)
        ds = None
    else:
        ds = torch.sort(prng.uniform(kd, (n_layers,), min_disparity,
                                     max_disparity), dim=-1).values
        d_bg = _col(ds[:, 0], device).expand(b, height, width)

    t = torch.tensor(float(camera_t), dtype=torch.float32, device=device)
    bg = _texture_params(kbg)
    right = _layer_texture(bg, x_hw, _shifted(y_hw, t, d_bg))
    left = _layer_texture(bg, x_hw, _shifted(y_hw, t - 1.0, d_bg))
    disparity = d_bg.clone()
    disparity_r = d_bg.clone()

    for i in range(1, n_layers):
        k = prng.fold_in(klayers, i)
        kr, kt = prng.split(k).unbind(-2)
        k1, k2, k3, k4, _ = prng.split(kr, 5).unbind(-2)
        rect_h = prng.uniform(k1, (), height / 6, height / 2)
        rect_w = prng.uniform(k2, (), width / 8, width / 3)
        x0 = prng.uniform(k3, (), -rect_h / 4, height - rect_h * 0.75)
        y0 = prng.uniform(k4, (), -rect_w / 4, width - rect_w * 0.75)
        if depth_prior:
            # The disparity is tied to the rectangle's vertical centre
            # (lower is closer); k5 is drawn and unused, as in JAX.
            lo, hi = _f32(min_disparity), _f32(max_disparity)
            center = torch.clamp((x0 + rect_h * 0.5)
                                 * (_f32(1.0) / height), 0.0, 1.0)
            d = torch.minimum(torch.maximum(lo + (hi - lo) * center, lo), hi)
        else:
            d = ds[:, i]
        x0, x1 = _col(x0, device), _col(x0 + rect_h, device)
        y0, y1 = _col(y0, device), _col(y0 + rect_w, device)
        d = _col(d, device)

        def rect_mask(yw):
            return (x_hw >= x0) & (x_hw < x1) & (yw >= y0) & (yw < y1)

        yw_r, yw_l = _shifted(y_hw, t, d), _shifted(y_hw, t - 1.0, d)
        mask_r, mask_l = rect_mask(yw_r), rect_mask(yw_l)
        tex = _texture_params(kt)
        right = torch.where(mask_r[:, None], _layer_texture(tex, x_hw, yw_r),
                            right)
        left = torch.where(mask_l[:, None], _layer_texture(tex, x_hw, yw_l),
                           left)
        disparity = torch.where(mask_l, d, disparity)
        disparity_r = torch.where(mask_r, d, disparity_r)
    if with_right_frame_gt:
        return left, right, disparity, disparity_r
    return left, right, disparity


def synthetic_stereo_scene(key: torch.Tensor, height: int, width: int,
                           min_disparity: float = 6.0,
                           max_disparity: float = 58.0, n_layers: int = 6,
                           depth_prior: bool = False,
                           with_right_frame_gt: bool = False,
                           camera_t: float = 0.0, device=None):
    """One scene -> ``(left (3, H, W), right (3, H, W), gt (H, W))`` in
    0..255 and left-frame pixels (plus ``gt_right`` with
    ``with_right_frame_gt``): ``stereo_tpu``'s scene of the same key.

    ``depth_prior=False`` draws every layer's disparity at random (a net
    can only match); ``True`` ties it to the vertical position (a ground
    ramp and "lower is closer"), which single-view synthesis needs.
    ``camera_t`` moves the rig ``camera_t`` baselines right: holding the
    key and stepping it gives a drive through one scene."""
    return tuple(a[0] for a in synthetic_stereo_scenes(
        key[None], height, width, min_disparity, max_disparity, n_layers,
        depth_prior, with_right_frame_gt, camera_t, device))


def synthetic_stereo_batch(key: torch.Tensor, batch_size: int, height: int,
                           width: int, min_disparity: float = 6.0,
                           max_disparity: float = 58.0, n_layers: int = 6,
                           depth_prior: bool = False,
                           with_right_frame_gt: bool = False, device=None):
    """``batch_size`` scenes of ``split(key, batch_size)`` -> ``(left
    (N, 3, H, W), right, gt (N, H, W))`` (plus ``gt_right``)."""
    return synthetic_stereo_scenes(
        prng.split(key, batch_size), height, width, min_disparity,
        max_disparity, n_layers, depth_prior, with_right_frame_gt, 0.0,
        device)


def mean_pool_nchw(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k means of (N, C, H, W) with H and W multiples of k."""
    n, c, h, w = x.shape
    return x.reshape(n, c, h // k, k, w // k, k).mean(dim=(3, 5))


def oracle_warp_batch(left_nchw: torch.Tensor,
                      d_right_nhw: torch.Tensor) -> torch.Tensor:
    """``out[n, c, x, y] = left[n, c, x, y + d_r(n, x, y)]`` (linear in y,
    edges clamped): the left views warped by the exact right-frame
    disparity, the reachable optimum of Deep3D's shifted-view blend."""
    n, c, h, w = left_nchw.shape
    y = torch.arange(w, dtype=torch.float32,
                     device=left_nchw.device) + d_right_nhw
    y0 = torch.floor(y)
    frac = (y - y0)[:, None]
    i0 = y0.to(torch.int64).clamp(0, w - 1)
    i1 = (i0 + 1).clamp(0, w - 1)

    def take(idx):
        return torch.gather(left_nchw, 3, idx[:, None].expand(n, c, h, w))

    return (1.0 - frac) * take(i0) + frac * take(i1)


# ---------------------------------------------------------------------------
# Trainers on generated scenes
# ---------------------------------------------------------------------------

def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """``optax.warmup_cosine_decay_schedule`` (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    from ``peak_value`` down to ``end_value`` at step ``decay_steps``,
    constant after.  Returns ``step -> learning rate``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive "
                         f"decay_steps, got {cosine_steps} (decay_steps "
                         f"{decay_steps} - warmup_steps {warmup_steps})")

    def schedule(step: int) -> float:
        if step < warmup_steps:
            count = min(max(step, 0), warmup_steps)
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(step - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _generator_from_key(key: torch.Tensor, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a key's two words:
    the dropout bits of a step follow the trainer's key stream (they are
    not JAX's bits, which come from its own dropout kernel)."""
    seed = (int(key[0]) << 32) | int(key[1])
    return torch.Generator(device=device).manual_seed(seed)


class _ChunkedTrainer:
    """The step loop shared by the synthetic trainers: JAX's ``chunk`` (the
    steps of one ``lax.scan`` dispatch) is the granularity at which losses
    come back to the host and are logged."""

    label = ""

    def _step(self) -> torch.Tensor:
        raise NotImplementedError

    def train(self, n_steps: Optional[int] = None,
              log_every_chunks: int = 5) -> List[float]:
        """Run ``n_steps`` (rounded up to whole chunks); returns per-step
        losses."""
        n_steps = n_steps if n_steps is not None else self.total_steps
        n_chunks = -(-n_steps // self.chunk)
        all_losses: List[float] = []
        start = time.time()
        for c in range(n_chunks):
            losses = torch.stack([self._step() for _ in range(self.chunk)])
            losses = losses.cpu().numpy()
            all_losses.extend(float(v) for v in losses)
            if log_every_chunks and (c % log_every_chunks == 0
                                     or c == n_chunks - 1):
                print(f"[{self.label}] step {self.step_count}: "
                      f"loss {losses.mean():.4f} "
                      f"({time.time() - start:.1f}s)", flush=True)
        return all_losses


class SyntheticStereoTrainer(_ChunkedTrainer):
    """Trains a stereo network (gwcnet, msnet2d, msnet3d) on generated
    random-disparity scenes: each step draws its own batch from the key
    stream (``PRNGKey(seed + 1)``, split once per step, as in JAX), then
    the multi-output loss, a global-norm clip at 5 and AdamW on optax's
    warmup-cosine schedule (from 5% of the learning rate up to it over
    ``warmup_steps``, down to 2% at ``total_steps``)."""

    def __init__(self, model_name: str, max_disparity: int = 64,
                 height: int = 256, width: int = 512, batch_size: int = 4,
                 learning_rate: float = 1e-3, weight_decay: float = 1e-4,
                 warmup_steps: int = 100, total_steps: int = 2000,
                 min_scene_disparity: float = 6.0,
                 max_scene_disparity: Optional[float] = None,
                 chunk: int = 20, seed: int = 0, state_dict=None,
                 device="cuda"):
        from ..core.device import resolve_device, set_float32_precision
        from ..models import build_stereo_model, init_params
        from .stereo_trainer import LOSSES

        self.device = resolve_device(device)
        set_float32_precision("float32")
        if max_scene_disparity is None:
            max_scene_disparity = max_disparity - 6.0
        self.model_name = self.label = model_name
        self.max_disparity = max_disparity
        self.chunk = chunk
        self.total_steps = total_steps
        self.batch = (batch_size, height, width, min_scene_disparity,
                      max_scene_disparity)
        self.loss_fn = LOSSES[model_name]
        model = build_stereo_model(model_name, max_disparity)
        if state_dict is None:
            init_params(model, seed)
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).train()
        self.schedule = warmup_cosine_decay_schedule(
            learning_rate * 0.05, learning_rate, warmup_steps, total_steps,
            learning_rate * 0.02)
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=self.schedule(0),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.key = prng.PRNGKey(seed + 1)
        self.step_count = 0

    def next_batch(self):
        """The next step's scenes: ``(left, right, gt)`` on the device."""
        self.key, sub = prng.split(self.key).unbind(0)
        b, h, w, lo, hi = self.batch
        return synthetic_stereo_batch(sub, b, h, w, lo, hi,
                                      device=self.device)

    def _step(self) -> torch.Tensor:
        from .stereo_trainer import stereo_step
        from .trainer import set_learning_rate

        left, right, gt = self.next_batch()
        set_learning_rate(self.optimizer, self.schedule(self.step_count))
        loss = stereo_step(self.model, self.optimizer, self.loss_fn,
                           self.max_disparity, left, right, gt,
                           clip_norm=5.0)
        self.step_count += 1
        return loss

    def export(self, checkpoint_path: str) -> None:
        """Parameters and ``batch_stats`` in the committed npz format
        (``.npz`` is appended when the path lacks it)."""
        from ..models import save_params_npz

        save_params_npz(self.model, checkpoint_path)


class SyntheticDeep3DTrainer(_ChunkedTrainer):
    """Trains Deep3D to synthesize the right view from the left on
    generated depth-prior scenes (``min/max_scene_disparity`` must match
    the evaluation family's 6..58: they define the appearance-to-depth
    mapping).

    The loss is the photometric L1 against ``photo_target`` ("right": the
    true right view; "oracle": the left view warped by the exact
    right-frame disparity, the blend's reachable optimum), plus
    ``disparity_loss_weight`` times a Huber loss (delta 1) between the
    volume's soft-argmax and the right-frame ground truth, plus
    ``ce_loss_weight`` times the cross-entropy to the two channels that
    straddle it.  AdamW, constant or (``schedule_steps`` > 0) warmup-cosine
    down to 5% over that horizon.  ``(height/4, width/4)`` must be
    multiples of 32.  ``init_state`` warm-starts from a donor state_dict:
    every entry of matching name and shape is adopted.
    """

    label = "deep3d"

    def __init__(self, height: int = 256, width: int = 512,
                 batch_size: int = 2, learning_rate: float = 2e-4,
                 weight_decay: float = 1e-4, chunk: int = 10, seed: int = 0,
                 min_scene_disparity: float = 6.0,
                 max_scene_disparity: float = 58.0,
                 disparity_loss_weight: float = 0.0,
                 ce_loss_weight: float = 0.0, schedule_steps: int = 0,
                 init_state=None, prob_volume_scale: int = 4,
                 photo_target: str = "right", device="cuda"):
        from ..core.device import resolve_device, set_float32_precision
        from ..models import (Deep3D, adopt_matching_leaves,
                              init_deep3d_params)

        if photo_target not in ("right", "oracle"):
            raise ValueError("photo_target must be 'right' or 'oracle'")
        self.device = resolve_device(device)
        set_float32_precision("float32")
        self.height, self.width = height, width
        self.prob_volume_scale = prob_volume_scale
        model = Deep3D((height // 4, width // 4),
                       prob_volume_scale=prob_volume_scale)
        init_deep3d_params(model, seed)
        if init_state is not None:
            n_kept = adopt_matching_leaves(model, init_state)
            print(f"[deep3d] warm start: adopted {n_kept} matching-shape "
                  f"leaves", flush=True)
        self.model = model.to(self.device).train()
        self.schedule = (warmup_cosine_decay_schedule(
            learning_rate * 0.05, learning_rate,
            max(100, schedule_steps // 100), schedule_steps,
            learning_rate * 0.05) if schedule_steps > 0
            else (lambda step: learning_rate))
        self.optimizer = torch.optim.AdamW(
            self.model.parameters(), lr=self.schedule(0),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
        self.key = prng.PRNGKey(seed + 1)
        self.chunk = chunk
        self.total_steps = 0
        self.step_count = 0
        self.w_disp = float(disparity_loss_weight)
        self.w_ce = float(ce_loss_weight)
        self.oracle_photo = photo_target == "oracle"
        self.supervised = (self.w_disp > 0.0 or self.w_ce > 0.0
                           or self.oracle_photo)
        self.batch = (batch_size, min_scene_disparity, max_scene_disparity)
        self.dropout = True

    def next_batch(self):
        """The next step's inputs in 0..1 and its dropout generator:
        ``(left, left_down, target, gt_right or None, generator)``."""
        self.key, kgen, kdrop = prng.split(self.key, 3).unbind(0)
        b, lo, hi = self.batch
        scenes = synthetic_stereo_batch(
            kgen, b, self.height, self.width, lo, hi, depth_prior=True,
            with_right_frame_gt=self.supervised, device=self.device)
        left, right = scenes[0] / 255.0, scenes[1] / 255.0
        gt_right = scenes[3] if self.supervised else None
        if self.oracle_photo:
            right = oracle_warp_batch(left, gt_right)
        gen = _generator_from_key(kdrop, self.device) if self.dropout \
            else None
        return left, mean_pool_nchw(left, 4), right, gt_right, gen

    def loss(self, left, down, target, gt_right, generator) -> torch.Tensor:
        """The training loss of one batch (differentiable)."""
        if not self.supervised:
            pred = self.model(left, down, generator)
            return (pred - target).abs().mean()
        pred, prob = self.model.synthesize_with_probabilities(left, down,
                                                              generator)
        total = (pred - target).abs().mean()
        if self.w_disp > 0.0:
            channels = torch.arange(prob.shape[1], dtype=prob.dtype,
                                    device=prob.device)
            err = torch.einsum("ndhw,d->nhw", prob, channels) - gt_right
            huber = torch.where(err.abs() <= 1.0, 0.5 * err * err,
                                err.abs() - 0.5)
            total = total + self.w_disp * huber.mean()
        if self.w_ce > 0.0:
            top = prob.shape[1] - 1
            gt_c = torch.clamp(gt_right, 0.0, float(top))
            lo = torch.floor(gt_c)
            frac = gt_c - lo
            logp = torch.log(prob + 1e-9)
            lo_i = lo.to(torch.int64)[:, None]
            hi_i = torch.clamp(lo_i + 1, max=top)
            ce = -((1.0 - frac) * torch.gather(logp, 1, lo_i)[:, 0]
                   + frac * torch.gather(logp, 1, hi_i)[:, 0])
            total = total + self.w_ce * ce.mean()
        return total

    def _step(self) -> torch.Tensor:
        from .trainer import set_learning_rate

        batch = self.next_batch()
        set_learning_rate(self.optimizer, self.schedule(self.step_count))
        loss = self.loss(*batch)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.step_count += 1
        return loss.detach()

    def export(self, checkpoint_path: str) -> None:
        """The weights as a committed-format npz with the training
        resolution in its ``meta`` (Deep3D's global branch ties them to
        it), which the synthesis wrapper adopts."""
        from .trainer import export_deep3d

        export_deep3d(self.model, checkpoint_path, (self.height, self.width))
