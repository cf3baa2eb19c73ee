"""Serving from pixels: ``serve.Predictor(..., tower=...)`` called in a
closed loop by one client, as ``serve.py``'s entry calls the feature
predictor (its loop, window, sample and check are reused), with uint8
crops in place of features.

Set-up makes the images and the tower's weights on the card from the
seed. Images: a class prototype in pixel space (128 + 40 Gaussian
noise a pixel) plus 30 Gaussian noise a pixel, rounded and clamped to
uint8, in class order; the traffic's set is moved to the host, as a
client holds it. Tower: a torchvision ``resnet34`` state dict,
convolutions drawn as torchvision's ``kaiming_normal_(mode="fan_out",
nonlinearity="relu")`` draws them, batch norm weight 1 and bias 0,
``fc`` as ``nn.Linear``'s default draws it; each batch norm's running
statistics are then set, in forward order, from its input over one
seeded calibration batch (``reference/resnet.py:calibrate``), so every
batch norm standardises as in a trained network. The game's weights are
``weights.py``'s, as every cell of the game has them.

The check runs the reference tower (``reference/resnet.py``) on the
sampled requests' pixels and judges the served answers on its features
(``reference/game.py:judge_answers``). The controls put in the
program's place: the whole pipeline in TF32, the tower alone in TF32,
and a planted fault (one block's shortcut dropped).
"""

import torch

from gamebench import compare, program
from gamebench.entries import serve
from gamebench.reference import resnet as ref_tower
from gamebench.reference.game import eval_answers, judge_answers

STD_PROTO, STD_NOISE = 40.0, 30.0
CALIBRATION_IMAGES = 32
PARTS = ("train", "dev", "calibration")


def make_pixels(cfg: dict, part: str, seed: int, device) -> torch.Tensor:
    """The ``part`` set's uint8 images ``(D * n, 3, S, S)`` on ``device``,
    in class order, ``n`` = ``<part>_per_class``; ``part`` "calibration"
    is :data:`CALIBRATION_IMAGES` images of the classes in turn."""
    D, shape = cfg["num_classes"], tuple(cfg["image_shape"])
    gen = torch.Generator(device=device).manual_seed(int(seed) + 4)
    proto = 128.0 + STD_PROTO * torch.randn((D,) + shape, generator=gen,
                                            device=device)
    # Each part's noise from a stream of its own.
    gen.manual_seed(int(seed) + 10 + PARTS.index(part))
    if part == "calibration":
        labels = torch.arange(CALIBRATION_IMAGES, device=device) % D
    else:
        labels = torch.arange(D, device=device).repeat_interleave(
            cfg[part + "_per_class"])
    out = torch.empty((labels.numel(),) + shape, dtype=torch.uint8,
                      device=device)
    for a in range(0, labels.numel(), 100):
        rows = labels[a:a + 100]
        x = proto[rows] + STD_NOISE * torch.randn(
            (rows.numel(),) + shape, generator=gen, device=device)
        out[a:a + 100] = x.round_().clamp_(0, 255).to(torch.uint8)
    return out


def tower_state(cfg: dict, seed: int, device) -> dict:
    """A seeded, calibrated ``resnet34`` state dict, float32 tensors on
    ``device`` in torchvision's key layout."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 5)
    sd = {}

    def conv(name, c_out, c_in, k):
        std = (2.0 / (c_out * k * k)) ** 0.5     # gain sqrt(2) / fan_out
        sd[name + ".weight"] = torch.empty(
            (c_out, c_in, k, k), device=device).normal_(0, std,
                                                        generator=gen)

    def bn(name, c):
        sd[name + ".weight"] = torch.ones(c, device=device)
        sd[name + ".bias"] = torch.zeros(c, device=device)
        sd[name + ".running_mean"] = torch.zeros(c, device=device)
        sd[name + ".running_var"] = torch.ones(c, device=device)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    c_in = 64
    for i, (blocks, c, stride) in enumerate(ref_tower.STAGES, start=1):
        for b in range(blocks):
            pre = f"layer{i}.{b}"
            conv(pre + ".conv1", c, c_in if b == 0 else c, 3)
            bn(pre + ".bn1", c)
            conv(pre + ".conv2", c, c, 3)
            bn(pre + ".bn2", c)
            if b == 0 and (stride != 1 or c_in != c):
                conv(pre + ".downsample.0", c, c_in, 1)
                bn(pre + ".downsample.1", c)
        c_in = c
    bound = 512 ** -0.5
    for name, shape in (("fc.weight", (1000, 512)), ("fc.bias", (1000,))):
        sd[name] = torch.empty(shape, device=device).uniform_(
            -bound, bound, generator=gen)
    ref_tower.calibrate(sd, make_pixels(cfg, "calibration", seed, device))
    return sd


class Entry(serve.Entry):
    def __init__(self, cell, config, traffic, seed, device, workdir):
        from multimodalgame_tpu_torch.game.config import GameConfig
        from multimodalgame_tpu_torch.models.resnet import (
            params_from_torch_state)
        from multimodalgame_tpu_torch.serve import Predictor
        self.cfg, self.traffic, self.device = config["cfg"], traffic, device
        self.sd = tower_state(self.cfg, seed, device)
        flags = program.make_flags(config, {"log_path": workdir,
                                            "experiment_name": cell})
        modules = program.agents(flags, config["weights"], device)
        self.predictor = Predictor(
            GameConfig.from_flags(flags), modules,
            program.description_pack(config["sets"]["desc"]), device=device,
            tower=params_from_torch_state(self.sd, device))
        batch = traffic["batch_size"]
        batch = int(self.cfg[batch] if isinstance(batch, str) else batch)
        pixels = make_pixels(self.cfg, traffic["set"], seed,
                             device).cpu().numpy()
        self.pool = [(pixels[a:a + batch], None)
                     for a in range(0, pixels.shape[0], batch)]
        self.sizes = [p.shape[0] for p, _ in self.pool]
        self.seed = seed
        self.kept = {}

    def after_window(self) -> None:
        """The tower's counters, shown beside the compared numbers."""
        from multimodalgame_tpu_torch.models.resnet import PixelTower
        self.info = {"tower_runs": PixelTower.runs,
                     "tower_images": PixelTower.images,
                     "tower_replays": PixelTower.replays}

    def metric_context(self) -> dict:
        return {"kind": "serve_pixels", "batches": self.served,
                "n_steps": self.n_steps,
                "image_size": self.cfg["image_shape"][-1]}

    def features(self, slot: int, **kw) -> torch.Tensor:
        """The reference tower's features of a request, at the tap the
        game reads."""
        pixels = torch.as_tensor(self.pool[slot][0], device=self.device)
        tap = self.cfg["img_feat"]
        return ref_tower.features(self.sd, pixels, (tap,), **kw)[tap]

    def judged(self, weights, desc, answers) -> list:
        out = []
        for slot, served in answers.items():
            out.append(judge_answers(weights, self.cfg, self.features(slot),
                                     desc, served))
        return out

    def control_readings(self, sets, weights) -> dict:
        """The controls in the program's place on the sampled requests:
        the reference in TF32 throughout (``control_tf32``), its tower
        alone in TF32 (``control_tf32_tower``), and its tower with one
        block's shortcut dropped (``fault_residual``)."""
        sides = {"control_tf32": ({"prec": "tf32"}, "tf32"),
                 "control_tf32_tower": ({"prec": "tf32"}, "f32"),
                 "fault_residual": ({"fault": "residual"}, "f32")}
        out = {}
        for side, (tower_kw, game_prec) in sides.items():
            answers = {}
            for slot in self.sample():
                answers[slot] = {
                    k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                    for k, v in eval_answers(
                        weights, self.cfg, self.features(slot, **tower_kw),
                        sets["desc"], prec=game_prec).items()}
            out[side] = compare.serve_numbers(
                self.judged(weights, sets["desc"], answers))
        return out
