"""Serving from photos through Qwen2.5-VL's vision tower:
``serve.Predictor(..., tower={"arch": "qwen2_5_vl_vision", ...})`` called
in a closed loop by one client, as ``serve_pixels.py``'s entry calls the
ResNet-34 predictor (its loop, window and sample are reused), with uint8
photos at their own aspect in place of square crops.

Set-up makes the images and the tower's weights on the card from the
seed. Images: ``serve_pixels.make_pixels`` at the configuration's
``image_shape`` (a class prototype in pixel space plus noise, uint8, in
class order); the traffic's set is moved to the host, as a client holds
it. Tower: a state dict in the published ``visual.*`` layout, every
weight drawn normal with the configuration's ``initializer_range``,
biases zero and RMSNorm weights one, cast to bfloat16
(:func:`tower_state`). The game's weights are ``weights.py``'s.

The check holds the tower and the game apart. After the window the
program's tower is run again on the sampled requests' photos, through
the same captured graph that served them (``Predictor.tower_outputs``).
The served answers of every sampled request are judged against the
reference game on the program's own features
(``reference/game.py:judge_answers``: ``bit_gap``, ``logprob_gap``,
``answer_gap``). The tower is held against the float32 reference tower
(``reference/qwen_vision.py``) on the traffic's ``feature_images`` of
the sampled requests' images, drawn from the seed: ``feature_gap`` is
the largest relative gap of an image's pooled features, ``token_gap``
that of one of its merged tokens, so that a fault confined to a few
windows is not averaged away. The controls put in the program's place:
the reference tower with its linear layers' operands in float8
(``control_fp8``) and four planted faults of it (every block over the
whole image, every block in windows, the rotary table's row and column
exchanged, the last two windows joined), each read by the tower's two
gaps; and the reference game in TF32 on the program's features
(``control_tf32_game``), read by the game's numbers (a tower's control
moves none of them: the game is judged on the features it was given).
"""

import random

import numpy as np
import torch

from gamebench import compare, program
from gamebench.entries import serve_pixels
from gamebench.reference import qwen_vision as ref_tower
from gamebench.reference.game import eval_answers, judge_answers

# The tower's controls: the reference's keywords in the program's place.
TOWER_CONTROLS = {"control_fp8": {"prec": "fp8"},
                  "fault_full_attention": {"fault": "full_attention"},
                  "fault_window_attention": {"fault": "window_attention"},
                  "fault_rope_swap": {"fault": "rope_swap"},
                  "fault_windows_joined": {"fault": "windows_joined"}}
COUNTERS = ("runs", "images", "tokens", "replays",
            "window_attention_launches", "full_attention_launches")


def tower_state(vcfg: dict, seed: int, device) -> dict:
    """A seeded state dict in the published ``visual.*`` layout, bfloat16
    on ``device``: weights normal with ``initializer_range``, biases
    zero, RMSNorm weights one."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 6)
    std = float(vcfg["initializer_range"])
    C, I = vcfg["hidden_size"], vcfg["intermediate_size"]
    P, T = vcfg["patch_size"], vcfg["temporal_patch_size"]
    U = C * vcfg["spatial_merge_size"] ** 2
    sd = {}

    def normal(name, *shape):
        sd["visual." + name] = torch.empty(shape, device=device).normal_(
            0, std, generator=gen).to(torch.bfloat16)

    def const(name, n, value):
        sd["visual." + name] = torch.full((n,), value, device=device,
                                          dtype=torch.bfloat16)

    def linear(name, n_in, n_out):
        normal(name + ".weight", n_out, n_in)
        const(name + ".bias", n_out, 0.0)

    normal("patch_embed.proj.weight", C, vcfg["in_channels"], T, P, P)
    for i in range(vcfg["depth"]):
        pre = f"blocks.{i}."
        const(pre + "norm1.weight", C, 1.0)
        const(pre + "norm2.weight", C, 1.0)
        linear(pre + "attn.qkv", C, 3 * C)
        linear(pre + "attn.proj", C, C)
        linear(pre + "mlp.gate_proj", C, I)
        linear(pre + "mlp.up_proj", C, I)
        linear(pre + "mlp.down_proj", I, C)
    const("merger.ln_q.weight", C, 1.0)
    linear("merger.mlp.0", U, U)
    linear("merger.mlp.2", U, vcfg["out_hidden_size"])
    return sd


class Entry(serve_pixels.Entry):
    def __init__(self, cell, config, traffic, seed, device, workdir):
        from multimodalgame_tpu_torch.game.config import GameConfig
        from multimodalgame_tpu_torch.models.qwen_vision import ARCH
        from multimodalgame_tpu_torch.serve import Predictor
        self.cfg, self.traffic, self.device = config["cfg"], traffic, device
        self.vcfg = dict(config["tower"]["vision_config"])
        self.sd = tower_state(self.vcfg, seed, device)
        flags = program.make_flags(config, {"log_path": workdir,
                                            "experiment_name": cell})
        modules = program.agents(flags, config["weights"], device)
        self.predictor = Predictor(
            GameConfig.from_flags(flags), modules,
            program.description_pack(config["sets"]["desc"]), device=device,
            tower={"arch": ARCH, "config": self.vcfg, "state": self.sd})
        batch = traffic["batch_size"]
        batch = int(self.cfg[batch] if isinstance(batch, str) else batch)
        pixels = serve_pixels.make_pixels(self.cfg, traffic["set"], seed,
                                          device).cpu().numpy()
        self.pool = [(pixels[a:a + batch], None)
                     for a in range(0, pixels.shape[0], batch)]
        self.sizes = [p.shape[0] for p, _ in self.pool]
        self.seed = seed
        self.kept = {}
        self.program_feats = {}
        self.checked = []
        self.program_tokens = None
        self.want = None

    def checked_images(self) -> list:
        """The images the tower is held to the reference on: ``(slot,
        row)`` of the sampled requests, the traffic's ``feature_images``
        of them drawn from the seed (all where there are fewer), in
        order."""
        pairs = [(s, r) for s in self.sample() for r in range(self.sizes[s])]
        n = min(len(pairs), int(self.traffic["feature_images"]))
        return sorted(random.Random(self.seed).sample(pairs, n))

    def after_window(self) -> None:
        """The program's features of the sampled requests and the merged
        tokens of the checked images, replayed through the graph that
        served them, and the tower's counters, shown beside the compared
        numbers."""
        from multimodalgame_tpu_torch.models.qwen_vision import VisionTower
        self.checked = self.checked_images()
        tokens = []
        for slot in self.sample():
            toks, feats = self.predictor.tower_outputs(self.pool[slot][0])
            self.program_feats[slot] = feats.cpu()
            rows = [r for s, r in self.checked if s == slot]
            if rows:
                tokens.append(toks[rows].cpu())
        self.program_tokens = torch.cat(tokens) if tokens else None
        self.info = {"tower_" + k: getattr(VisionTower, k)
                     for k in COUNTERS}

    def metric_context(self) -> dict:
        return {"kind": "serve_photos", "batches": self.served,
                "n_steps": self.n_steps,
                "image_hw": tuple(self.cfg["image_shape"][1:]),
                "vision_config": self.vcfg}

    def reference(self, sd, **kw) -> dict:
        """The reference tower's merged tokens and pooled features of the
        checked images (float32; ``kw`` its precision or fault)."""
        pixels = np.stack([self.pool[s][0][r] for s, r in self.checked])
        return ref_tower.forward(sd, self.vcfg, torch.as_tensor(
            pixels, device=self.device), **kw)

    def tower_gaps(self, tokens, feats, want) -> dict:
        """``feature_gap`` and ``token_gap`` of the checked images'
        ``tokens`` ``(n, M, out_hidden)`` and ``feats`` ``(n, out_hidden)``
        against the reference's ``want``."""
        def largest(got, ref, block=ref_tower.BLOCK):   # float64 a block
            return max(float(ref_tower.relative_gaps(
                got[a:a + block].to(self.device).flatten(0, -2),
                ref[a:a + block].flatten(0, -2)).max())
                for a in range(0, ref.shape[0], block))
        return {"feature_gap": largest(feats, want["features"]),
                "token_gap": largest(tokens, want["tokens"])}

    def judged(self, weights, desc, answers) -> list:
        """The answers by slot judged on the program's features."""
        return [judge_answers(weights, self.cfg,
                              self.program_feats[slot].to(self.device),
                              desc, served)
                for slot, served in answers.items()]

    def check(self, sets, weights) -> dict:
        """The tower's gaps on the checked images, and every sampled
        request's answers judged on the program's features; none where no
        request was served."""
        slots = self.sample()
        if not slots:
            return {}
        self.want = self.reference(ref_tower.state(self.sd, self.device))
        feats = torch.stack([self.program_feats[s][r]
                             for s, r in self.checked])
        out = self.tower_gaps(self.program_tokens, feats, self.want)
        out.update(compare.serve_numbers(self.judged(
            weights, sets["desc"], {s: self.kept[s] for s in slots})))
        return out

    def control_readings(self, sets, weights) -> dict:
        """Each of :data:`TOWER_CONTROLS` in the program's tower's place
        on the checked images, and the reference game in TF32 in the
        program's game's place on the sampled requests."""
        sd = ref_tower.state(self.sd, self.device)
        if self.want is None:
            self.want = self.reference(sd)
        out = {}
        for side, kw in TOWER_CONTROLS.items():
            got = self.reference(sd, **kw)
            out[side] = self.tower_gaps(got["tokens"], got["features"],
                                        self.want)
        answers = {}
        for slot in self.sample():
            answers[slot] = {
                k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                for k, v in eval_answers(
                    weights, self.cfg,
                    self.program_feats[slot].to(self.device), sets["desc"],
                    prec="tf32").items()}
        out["control_tf32_game"] = compare.serve_numbers(
            self.judged(weights, sets["desc"], answers))
        return out
