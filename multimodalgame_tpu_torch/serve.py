"""Batch inference / serving on PyTorch.

The port of ``multimodalgame_tpu/serve.py``: the deterministic eval
conversation as a checkpoint-loadable predictor. On a GPU each request
batch runs the whole conversation in one CUDA kernel launch
(ops/cuda_exchange.py), inside one captured CUDA graph a request shape
with the answer, for every config the kernel supports; the others
(attention, ``mou``, ``-flipout_dev`` with flipout) run the plain
conversation. Visual attention with ``attn_extra_context`` needs each
request's ``fc`` context, description attention the pack's padded word
sets. Under ``-flipout_dev`` every request flips bits with the same draws
(Philox keyed by ``(0, 0)``, slot 0), as the JAX Predictor's fixed key
does.

Several devices (JAX's ``Predictor(mesh=...)``, serve.py:36-71): the
modules and descriptions are replicated on each device of a list, and a
request's rows are split into one block a device (a batch the devices do
not divide runs whole on the first, where JAX replicates it). There are
no collectives, and one process drives every device: the blocks' launches
go out back to back, and their records are joined on the first device,
where the answer is computed as for one device. ``-mesh N`` (``-1``: every
card) serves on the first N visible cards, and raises when there are
fewer.

From pixels (``Predictor(..., tower=params)``): ResNet-34
(``models/resnet.py:PixelTower``, the reference's ``FeatureModel``,
utils/package_data.py:81-131) in front of the game. A request is then
uint8 crops ``(B, 3, S, S)``, already scaled and centre-cropped (227 x
227, utils/package_data.py:171-178); on the device they are normalised
and run to the tap the game's ``img_feat`` names (its batch norms folded
into its convolutions, each convolution followed by one hand-written
kernel on a card), one captured CUDA graph a request shape on a card,
whose output the eval conversation reads on the device. Or
(``tower={"arch": "qwen2_5_vl_vision", "config": ..., "state": ...}``)
Qwen2.5-VL's vision tower (``models/qwen_vision.py:VisionTower``): photos
``(B, 3, H, W)`` at their own aspect, each side a multiple of 28 as the
processor's ``smart_resize`` leaves it, in bfloat16 to the mean of the
merger's tokens, whose width must be the game's ``img_feat_dim``; one
captured CUDA graph a request shape on a card. The tower is replicated
on each device like the modules.
Attention with ``attn_extra_context`` (an ``fc`` context beside the
maps) is served from features only.

CLI: ``python -m multimodalgame_tpu_torch.serve -checkpoint <path>
-log_load <train json> -dev_file <hdf5>`` prints JSONL predictions, the
same lines as the JAX package's serve.
"""

from __future__ import annotations

import copy
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from multimodalgame_tpu_torch.config import Flags
from multimodalgame_tpu_torch.data.descriptions import DescriptionPack
from multimodalgame_tpu_torch.game.agents import AgentModules
from multimodalgame_tpu_torch.game.config import GameConfig
from multimodalgame_tpu_torch.game.exchange import (description_inputs,
                                                    turns_run)
from multimodalgame_tpu_torch.game.train import (answer_scores,
                                                 make_eval_exchange)
from multimodalgame_tpu_torch.models import qwen_vision
from multimodalgame_tpu_torch.models.resnet import PixelTower
from multimodalgame_tpu_torch.ops.philox import philox_eval_uniforms
from multimodalgame_tpu_torch.utils.checkpoint import load_agents
from multimodalgame_tpu_torch.utils.cuda_graph import clone_tree
from multimodalgame_tpu_torch.utils.device import resolve_device
from multimodalgame_tpu_torch.utils.profiling import span

Device = Optional[Union[str, torch.device]]
Devices = Union[Device, Sequence[Union[str, torch.device]]]
# The record fields a prediction reads.
_ANSWER = ("y", "stop_masks", "stop_feats", "sen_feats", "rec_feats")


class Predictor:
    """Checkpoint-backed batched game predictor.

    ``device`` defaults to ``cuda`` (and raises without a GPU); pass
    ``device="cpu"`` for the plain PyTorch path on the CPU, or a list of
    devices (one may repeat) to split each request's rows over them.
    ``use_kernel`` routes supported configs through the fused CUDA kernel;
    the others take the plain conversation. On a card each request shape
    runs as one captured CUDA graph of either
    (``game/train.py:make_eval_exchange``); ``graph=False`` launches it
    eagerly.

    ``tower``: ResNet-34's parameters
    (``models/resnet.py:params_from_torch_state`` of a torchvision
    state dict, or ``load_pretrained(path)``), or Qwen2.5-VL's vision
    tower as ``{"arch": "qwen2_5_vl_vision", "config": <vision_config>,
    "state": <state dict in the visual.* layout>}``; :meth:`predict` then
    takes uint8 pixels (``(B, 3, S, S)``, or ``(B, 3, H, W)`` with H and W
    multiples of 28) and runs the tower first, as one more captured graph
    a request shape on a card (``graph=False``: eagerly).
    """

    def __init__(self, cfg: GameConfig, modules: AgentModules,
                 desc_pack: DescriptionPack, device: Devices = None,
                 use_kernel: bool = True, graph: Optional[bool] = None,
                 tower: Optional[Dict] = None):
        if tower is not None and cfg.visual_attn and \
                cfg.attn_extra_context:
            raise ValueError("a tower serves the img_feat tap alone: "
                             "attention with attn_extra_context is served "
                             "from features and their fc context")
        self.devices = [resolve_device(d) for d in (
            device if isinstance(device, (list, tuple)) else [device])]
        self.device = self.devices[0]
        self.cfg = cfg
        self.desc_pack = desc_pack
        # One replica a distinct device: the modules, the descriptions
        # and the eval conversation.
        self._replicas = {}
        for dev in self.devices:
            if dev in self._replicas:
                continue
            mods = (modules if not self._replicas
                    else copy.deepcopy(modules)).to(dev).eval()
            descs = description_inputs(desc_pack, cfg, dev)
            self._replicas[dev] = (mods, descs,
                                   make_eval_exchange(mods,
                                                      use_kernel=use_kernel,
                                                      graph=graph))
        self.modules, self._descs, self._exchange = \
            self._replicas[self.device]
        self._desc = self._descs["desc"].contiguous()
        # The tower, one a distinct device; none serves features.
        self._towers = {} if tower is None else {
            dev: build_tower(tower, cfg, dev, graph)
            for dev in self._replicas}

    @classmethod
    def from_checkpoint(cls, flags: Flags, desc_pack: DescriptionPack,
                        device: Devices = None,
                        use_kernel: bool = True,
                        tower: Optional[Dict] = None) -> "Predictor":
        """Load ``flags.checkpoint``: the JAX package's msgpack file or
        Orbax directory, or a reference ``.pt``, told apart by content, as
        JAX's serving reads them (serve.py:104-118). ``-mesh_model`` raises ``ValueError``, as
        JAX's serving does (serve.py:166-169). ``tower`` as for the
        constructor."""
        refuse_mesh_model(flags)
        cfg = GameConfig.from_flags(flags)
        _, modules = load_agents(flags.checkpoint, cfg)
        return cls(cfg, modules, desc_pack, device=device,
                   use_kernel=use_kernel, tower=tower)

    @torch.inference_mode()
    def predict(self, features: np.ndarray,
                data_context: Optional[np.ndarray] = None) -> Dict:
        """Run conversations for a feature batch ``(B, feat)`` (``(B,
        feat, H, W)`` maps under visual attention, with their context
        ``(B, attn_context_dim)`` under ``attn_extra_context``); with a
        tower, for uint8 pixels: ResNet-34 takes square crops ``(B, 3, S,
        S)``, the vision tower ``(B, 3, H, W)`` with H and W multiples of
        28. Input of another kind raises ``ValueError``, naming what this
        Predictor takes.

        Returns a dict with ``prediction`` (B,), ``log_probs`` (B, D),
        ``conversation_length`` (B,), ``sender_messages`` /
        ``receiver_messages`` (n, B, W), and ``n_steps``.

        The call is the span ``mmg.predict`` (``utils/profiling.py:span``);
        inside it, each block's inputs to its device
        (``mmg.predict.input``; pixels go into the tower's input buffer),
        with a tower its forward (``mmg.predict.tower``, on a card one
        graph replay), and its conversation (``mmg.predict.replay``, on a
        card one graph replay), then the copies of the answer to the host
        (``mmg.predict.copy_back``, which waits for the conversation).
        """
        with span("predict"):
            if self._towers:
                features = self._pixels(features)
            elif getattr(features, "dtype", None) == np.uint8:
                raise ValueError("uint8 pixels need a Predictor built with "
                                 "tower=<a tower's parameters>; this one "
                                 "serves float features (B, feat)")
            else:
                features = np.asarray(features, np.float32)
            batch = features.shape[0]
            nd = len(self.devices)
            per = batch // nd if nd > 1 and batch % nd == 0 else batch
            blocks = [self._block(features, data_context, lo, lo + per,
                                  dev)
                      for lo, dev in zip(range(0, batch, per),
                                         self.devices)]
            if len(blocks) == 1:
                ex, dist = blocks[0]
            else:
                ex = blocks[0][0]._replace(**{k: torch.cat(
                    [getattr(b, k).to(self.device) for b, _ in blocks],
                    dim=1) for k in _ANSWER})
                ex = ex._replace(n_steps=turns_run(ex.stop_masks,
                                                   self.cfg.fixed_exchange))
                # Fixed exchanges score the LAST turn, like training and
                # eval (the stop unit gets no training signal in fixed
                # mode).
                dist = answer_scores(self.cfg, ex)
            with span("predict.copy_back"):
                dist = dist.cpu().numpy()
                n = int(ex.n_steps)
                return {
                    "prediction": dist.argmax(axis=1),
                    "log_probs": dist,
                    "conversation_length": ex.stop_feats[:n].sum(dim=(0, 2))
                    .cpu().numpy(),
                    "sender_messages": ex.sen_feats[:n].cpu().numpy(),
                    "receiver_messages": ex.rec_feats[:n].cpu().numpy(),
                    "n_steps": n,
                }

    @torch.inference_mode()
    def tower_outputs(self, images) -> Tuple[torch.Tensor, torch.Tensor]:
        """The vision tower's merged tokens and pooled features for uint8
        ``images`` on the first device, as :meth:`predict` computes them
        for a batch it runs whole there (on a card, a replay of the same
        graph): copies."""
        x = self._pixels(images)
        tower = self._towers[self.device]
        return clone_tree(tower.outputs(tower.stage(x)))

    def _block(self, features: np.ndarray,
               data_context: Optional[np.ndarray], lo: int, hi: int,
               dev: torch.device):
        """The eval conversation of rows ``[lo, hi)`` on ``dev``'s replica,
        with those rows' ``-flipout_dev`` draws, and its answer (on a
        card, with the kernel, both from one captured graph)."""
        mods, descs, run = self._replicas[dev]
        tower = self._towers.get(dev)
        with span("predict.input"):
            if tower is None:
                data = torch.as_tensor(features[lo:hi],
                                       device=dev).contiguous()
                ctx = (None if data_context is None else torch.as_tensor(
                    np.asarray(data_context, np.float32)[lo:hi], device=dev))
            else:
                key, ctx = tower.stage(features[lo:hi]), None
            uniforms = philox_eval_uniforms(self.cfg, hi - lo, 0, 0, 0, dev,
                                            row_base=lo)
        if tower is not None:
            with span("predict.tower"):
                data = tower(key)
        with span("predict.replay"):
            return run(data, descs["desc"].contiguous(), data_context=ctx,
                       desc_set_padded=descs["desc_set_padded"],
                       desc_set_mask=descs["desc_set_mask"],
                       uniforms=uniforms, answer=True)

    def _pixels(self, images) -> np.ndarray:
        """``images`` as the tower's input, or ``ValueError`` naming what
        this Predictor's tower takes."""
        x = np.asarray(images)
        self._towers[self.device].check(x)
        return x


def build_tower(tower: Dict, cfg: GameConfig, device: torch.device,
                graph: Optional[bool]):
    """The served tower on ``device``: Qwen2.5-VL's vision tower for a
    dict whose ``arch`` names it (``ValueError`` unless its width is the
    game's ``img_feat_dim``), else ResNet-34 to the game's tap."""
    if tower.get("arch") == qwen_vision.ARCH:
        width = int(tower["config"]["out_hidden_size"])
        if width != cfg.img_feat_dim:
            raise ValueError(
                f"the vision tower's features are {width} wide; the game "
                f"reads img_feat_dim = {cfg.img_feat_dim}")
        return qwen_vision.VisionTower(
            qwen_vision.params_from_state(tower["state"], tower["config"],
                                          device),
            tower["config"], device, graph=graph)
    return PixelTower(tower, cfg.img_feat, device, graph=graph)


def refuse_mesh_model(flags: Flags) -> None:
    if int(flags.mesh_model or 0) > 1:
        raise ValueError(
            "-mesh_model is a training option; serving shards "
            "the request batch axis only — drop -mesh_model")


def serving_devices(mesh: int, device: Devices = None) -> List[torch.device]:
    """The devices ``-mesh`` serves on (``game/driver.py:device_pool``):
    one for 0 or 1, the first ``mesh`` (-1: all) of the pool otherwise;
    ``ValueError`` when it has fewer."""
    from multimodalgame_tpu_torch.game.driver import device_pool
    if mesh in (0, 1):
        return [resolve_device(device[0] if isinstance(device, (list, tuple))
                               else device)]
    pool = device_pool(device, mesh)
    if mesh == -1:
        return pool
    if len(pool) < mesh:
        raise ValueError(f"requested a {mesh}-device mesh but only "
                         f"{len(pool)} devices are available")
    return pool[:mesh]


def main(argv=None, device: Devices = None) -> None:
    from multimodalgame_tpu_torch.config import flags_from_argv
    from multimodalgame_tpu_torch.data.descriptions import load_descriptions
    from multimodalgame_tpu_torch.data.hdf5_loader import load_hdf5

    flags = flags_from_argv(argv)
    refuse_mesh_model(flags)
    devices = serving_devices(int(flags.mesh or 0), device)
    desc_pack = load_descriptions(flags.descr_dev, flags.wv_type,
                                  flags.wv_dim, glove_path=flags.glove_path)
    pred = Predictor.from_checkpoint(flags, desc_pack, device=devices)
    for batch in load_hdf5(flags.dev_file, flags.batch_size_dev, 0,
                           shuffle=False, truncate_final_batch=True,
                           map_labels=desc_pack.map_labels):
        # Attention with context needs the fc column (JAX serve.py:181-185).
        ctx = (batch[flags.data_context] if pred.cfg.attn_extra_context
               else None)
        out = pred.predict(batch[flags.img_feat], data_context=ctx)
        for ex_id, p, true in zip(batch["example_ids"], out["prediction"],
                                  batch["target"]):
            print(json.dumps({
                "example_id": ex_id.decode() if isinstance(ex_id, bytes)
                else str(ex_id),
                "prediction": int(p),
                "label": pred.desc_pack.idx_to_label.get(int(p)),
                "target": int(true),
            }))


if __name__ == "__main__":
    main(sys.argv[1:])
