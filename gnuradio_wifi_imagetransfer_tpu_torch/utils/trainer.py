"""SOMANet training: the IRS environment, the loss modes and the trainer
(PyTorch port of the JAX package's utils/trainer.py, utils/Trainer.py:57-193
of the reference).

The environment draws user positions from numpy's ``default_rng(0)`` (as the
JAX package does) and Rician channel refreshes from a ``torch.Generator``.
The trainer runs ``torch.optim.Adam`` (optax.adam's betas and eps) with a
learning rate that may be a schedule of the optimizer's update count
(``cosine_decay_schedule`` gives optax's rates), on ``device`` ("cuda"
unless the caller asks for the CPU). Every mode runs the model with
``train=True``, so BatchNorm's running statistics move as in the JAX
package's ``mutable=["batch_stats"]`` step. Forward and backward run
inside ``fp32_convs()``: cuDNN in float32 with TF32 off, deterministic
algorithms.

The trainer takes any ``nn.Module`` whose ``forward(images, labels,
train)`` maps (U, B, 3, H, W) images and (U, 256) labels to (U, B, 3, H, W)
outputs; its step functions take the JAX package's NHWC batches (numpy or
tensors; uint8 pixels are ImageNet-normalised on the device) and move the
channels first on the device. Checkpoints are ``torch.save`` files where
the JAX package writes orbax ones.

``mesh=make_data_mesh(group=...)`` trains data-parallel, as the JAX
package's pjit step over a ("data",) mesh does: every rank is given the
whole batch and keeps its slice of the per-user batch axis B, parameters
are replicated (broadcast from the group's first rank when the trainer is
made), each rank's loss takes the GLOBAL count as its denominator, the
model's ``layers.BatchNorm`` layers normalise by the group's whole batch
(``layers.global_batch``), the gradients are SUM-all-reduced in one flat
buffer after each backward (the loss with them, so the returned loss is
the global one), and Adam then runs identically on every rank. B must
split evenly over the mesh.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from gnuradio_wifi_imagetransfer_tpu_torch.channel.irs import ClusteredIRSChannel
from gnuradio_wifi_imagetransfer_tpu_torch.models.jsce import IMAGENET_MEAN, IMAGENET_STD
from gnuradio_wifi_imagetransfer_tpu_torch.models.layers import fp32_convs, global_batch
from gnuradio_wifi_imagetransfer_tpu_torch.parallel.mesh import Mesh
from gnuradio_wifi_imagetransfer_tpu_torch.utils.device import resolve


# ---------------------------------------------------------------------------
# Environment (Trainer.reset / get_pos)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Environment:
    """Dynamic multi-user IRS environment (Trainer.py:57-118). Its channels
    lie on ``device``."""

    user_num: int = 2
    antenna_num: int = 1
    irs_scale: int = 16
    snr: float = 20.0
    ap_pos: tuple = (0.24, 0.24, 4.5)
    irs_pos: tuple = (0.015, 0.015, 0.0)
    interval: float = 0.03
    dynamic_user_num: bool = False
    dynamic_position: bool = False
    device: str = "cuda"

    def __post_init__(self):
        self._rng = np.random.default_rng(0)
        self.usr_pos = None
        self._rebuild()

    def _rebuild(self):
        self.chnl = ClusteredIRSChannel(
            irs_unit_gap=self.interval, irs_scale=self.irs_scale,
            irs_pos=self.irs_pos, ap_pos=self.ap_pos, cluster_scale=1,
            user_num=self.user_num, ap_num=self.antenna_num, device=self.device)

    def reset(self, generator: torch.Generator, k_factor: float = 10.0):
        """Draw a new episode: user count, positions, LoS, Rician refresh,
        per-user SNRs (Trainer.py reset :98-118)."""
        if self.dynamic_user_num:
            self.user_num = int(self._rng.integers(1, 5))
            self._rebuild()
        if self.dynamic_position or self.usr_pos is None:
            self.usr_pos = np.column_stack([
                self._rng.random(self.user_num) * 10,
                self._rng.random(self.user_num) * 10,
                np.full(self.user_num, 1.5),
            ])
            self._los = self.chnl.gen_los(self.usr_pos)
            if self.dynamic_position:
                self.snr = list(self._rng.integers(0, 20, self.user_num))
        return self.chnl.gen_chnl(generator, self._los, k_factor), self.snr

    def get_pos(self, with_irs: bool = True, with_ap: bool = True):
        """Graph for GNN-based schedulers (Trainer.py get_pos :169-193)."""
        nodes = [np.asarray(self.usr_pos)]
        if with_irs:
            nodes.insert(0, np.asarray(self.irs_pos)[None])
        if with_ap:
            nodes.insert(0, np.asarray(self.ap_pos)[None])
        graph = np.vstack(nodes).astype(np.float32)
        n = graph.shape[0]
        x, y = np.meshgrid(np.arange(n), np.arange(n))
        edge_index = np.vstack([x.ravel(), y.ravel()]).astype(np.int64)
        return graph, edge_index


# ---------------------------------------------------------------------------
# Losses (Trainer.train / distill)
# ---------------------------------------------------------------------------


def _per_user_mse(out: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    return ((out - images) ** 2).mean(dim=tuple(range(1, images.ndim)))


def mse_loss(model: nn.Module, images, labels, train: bool = False) -> torch.Tensor:
    """'default' mode: mse(output, input) / user_num (Trainer.py:149-152).
    With ``train`` the model's BatchNorm statistics move, as a torch
    module's do."""
    return ((model(images, labels, train) - images) ** 2).mean() / images.shape[0]


def m2m_loss(model: nn.Module, images, labels) -> torch.Tensor:
    """'m2m' mode: per-user mse averaged (Trainer.py:122-131)."""
    return _per_user_mse(model(images, labels), images).mean()


def multiband_loss(model: nn.Module, band_images: dict, band_labels: dict,
                   freq_weight: Optional[dict] = None) -> torch.Tensor:
    """'multi-band' mode: frequency-weighted per-band mse
    (Trainer.py:133-144)."""
    total, scaler = 0.0, 0.0
    for f, imgs in band_images.items():
        w = 1.0 if freq_weight is None else freq_weight[f]
        total = total + w * ((model(imgs, band_labels[f]) - imgs) ** 2).mean()
        scaler += w
    return total / scaler


def distill_loss(student: nn.Module, teacher: nn.Module, images, labels,
                 decay: float = 0.1) -> torch.Tensor:
    """Distillation: student-vs-input + decay * student-vs-teacher
    (Trainer.py distill :157-167); no gradient reaches the teacher."""
    out_s = student(images, labels)
    with torch.no_grad():
        out_t = teacher(images, labels)
    return ((out_s - images) ** 2).mean() + decay * ((out_s - out_t) ** 2).mean()


# ---------------------------------------------------------------------------
# Schedule and trainer
# ---------------------------------------------------------------------------


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule's rate at an update count, in float32 as
    optax computes it: init * ((1 - alpha) * 0.5 * (1 + cos(pi * t / T)) +
    alpha) with t = min(count, T); past T it stays at init * alpha."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine schedule needs positive decay_steps, got {decay_steps}")
    f32 = np.float32

    def schedule(count: int) -> float:
        t = f32(min(float(count), float(decay_steps)))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * t / f32(decay_steps)))
        return float(f32(init_value) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


class Trainer:
    """SOMANet training with the reference's loss modes.

    ``train_step(images, labels, mode)`` takes one Adam step in the
    'default' / 'm2m' / 'distill' mode (Trainer.py:120-167);
    ``train_step_multiband`` handles the per-band workload; ``train_steps``
    takes K steps from one batch that crosses to the device once.
    ``step`` counts the steps taken (a warm start may set it);
    ``count`` counts the optimizer's updates, the schedule's argument.
    """

    MODES = ("default", "m2m", "distill")

    def __init__(self, model: nn.Module, learning_rate: float | Callable[[int], float] = 1e-4,
                 mesh: Mesh | None = None, distill_decay: float = 0.1, device="cuda"):
        if mesh is not None and mesh.axis_names != ("data",):
            raise ValueError(f"the trainer takes a 1-D ('data',) mesh (make_data_mesh), "
                             f"got axes {mesh.axis_names}")
        self.device = resolve(device)
        self.model = model.to(self.device)
        self.mesh = mesh
        self.group = None if mesh is None else mesh.group
        if self.group is not None:
            src = dist.get_global_rank(self.group, 0)
            for v in self.model.state_dict().values():
                dist.broadcast(v, src, group=self.group)
        self.schedule = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.schedule(0),
                                          betas=(0.9, 0.999), eps=1e-8)
        self.distill_decay = distill_decay
        self.teacher: Optional[nn.Module] = None
        self.step = 0
        self.count = 0

    # -- inputs -----------------------------------------------------------

    def _images(self, images) -> torch.Tensor:
        """NHWC images (numpy or tensor, float or uint8 pixels) -> float32
        NCHW on the device; uint8 is ImageNet-normalised here."""
        x = torch.as_tensor(images, device=self.device)
        if x.dtype == torch.uint8:
            mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
            std = torch.as_tensor(IMAGENET_STD, device=self.device)
            x = (x.to(torch.float32) / 255.0 - mean) / std
        return x.to(torch.float32).movedim(-1, -3).contiguous()

    def _labels(self, labels) -> torch.Tensor:
        return torch.as_tensor(labels, dtype=torch.float32, device=self.device)

    def _local(self, x, axis: int):
        """This rank's slice of the per-user batch axis (``axis`` of x) and
        its share of the global batch; the whole x and 1 without a mesh."""
        if self.mesh is None:
            return x, 1.0
        b, shards = x.shape[axis], self.mesh.shape["data"]
        if b % shards:
            raise ValueError(f"per-user batch {b} does not split evenly over the data "
                             f"mesh's {shards} shards")
        cells = self.mesh.local[0]
        per = b // shards
        idx = (slice(None),) * axis + (slice(cells.start * per, cells.stop * per),)
        return x[idx], (cells.stop - cells.start) / shards

    # -- one update ---------------------------------------------------------

    def _loss(self, mode: str, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        out = self.model(images, labels, True)
        if mode == "default":
            return ((out - images) ** 2).mean() / images.shape[0]
        if mode == "m2m":
            return _per_user_mse(out, images).mean()
        with torch.no_grad():
            out_t = self.teacher(images, labels, False)
        return (_per_user_mse(out, images)
                + self.distill_decay * _per_user_mse(out, out_t)).mean()

    def _update(self, loss_fn: Callable[[], torch.Tensor], share: float = 1.0) -> torch.Tensor:
        """One Adam update on the gradient of loss_fn() at the schedule's
        rate for this update count. A parameter that the loss does not
        reach gets a zero gradient, so its moments and its step count move
        as optax's do. On a data mesh over a group, loss_fn() is this
        rank's mean, weighted by its ``share`` of the global batch, and the
        gradients and the loss are summed over the group in one buffer."""
        self.optimizer.zero_grad(set_to_none=True)
        with fp32_convs(), global_batch(self.group):
            loss = loss_fn() * share
            loss.backward()
        params = [p for group in self.optimizer.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = loss.detach()
        if self.group is not None:
            flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1)])
            dist.all_reduce(flat, group=self.group)
            off = 0
            for p in params:
                p.grad.copy_(flat[off: off + p.numel()].view_as(p))
                off += p.numel()
            loss = flat[-1]
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.count)
        self.optimizer.step()
        self.count += 1
        return loss

    def _step(self, mode: str, images: torch.Tensor, labels: torch.Tensor,
              share: float = 1.0) -> torch.Tensor:
        loss = self._update(lambda: self._loss(mode, images, labels), share)
        self.step += 1
        return loss

    def _check_mode(self, mode: str) -> None:
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode!r}")
        if mode == "distill" and self.teacher is None:
            self.set_teacher()

    # -- public API ---------------------------------------------------------

    def set_teacher(self, teacher: Optional[nn.Module] = None) -> None:
        """Freeze a teacher for 'distill' mode (by default a snapshot of the
        current student, like Trainer.py distill's teacher.eval())."""
        teacher = copy.deepcopy(self.model if teacher is None else teacher)
        self.teacher = teacher.to(self.device).requires_grad_(False)

    def train_step(self, images, labels, mode: str = "default") -> float:
        """One step on (U, B, H, W, 3) images and (U, 256) labels."""
        self._check_mode(mode)
        images, share = self._local(images, 1)
        return float(self._step(mode, self._images(images), self._labels(labels), share))

    def train_steps(self, images_seq, labels_seq, mode: str = "default") -> np.ndarray:
        """K steps from images_seq (K, U, B, H, W, 3) and labels_seq (K, U,
        256); returns the K losses. The batch crosses to the device once
        (uint8 pixels are normalised there) and the losses come back once,
        after the last step."""
        self._check_mode(mode)
        images_seq, share = self._local(images_seq, 2)
        images_seq = torch.as_tensor(images_seq, device=self.device)
        labels_seq = self._labels(labels_seq)
        losses = [self._step(mode, self._images(images_seq[i]), labels_seq[i], share)
                  for i in range(images_seq.shape[0])]
        return torch.stack(losses).cpu().numpy()

    def train_step_multiband(self, band_images, band_labels, freq_weight=None) -> float:
        """'multi-band' mode (Trainer.py:133-144): band_images (F, U, B, H,
        W, 3), band_labels (F, U, 256), freq_weight (F,) or None."""
        band_images, share = self._local(band_images, 2)
        images = self._images(band_images)
        labels = self._labels(band_labels)
        weights = np.ones(images.shape[0]) if freq_weight is None else np.asarray(freq_weight)

        def loss_fn():
            total = 0.0
            for f in range(images.shape[0]):
                out = self.model(images[f], labels[f], True)
                total = total + float(weights[f]) * ((out - images[f]) ** 2).mean()
            return total / float(weights.sum())

        loss = self._update(loss_fn, share)
        self.step += 1
        return float(loss)

    # -- checkpoints (torch.save) -------------------------------------------

    def save(self, path: str) -> None:
        """Parameters, BatchNorm statistics and the step (the JAX package's
        orbax checkpoint keeps the same; no optimizer state)."""
        torch.save({"model": self.model.state_dict(), "step": self.step}, path)

    def restore(self, path: str) -> None:
        """Load ``save``'s file; the optimizer state stays as it is."""
        ckpt = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        self.step = int(ckpt["step"])
