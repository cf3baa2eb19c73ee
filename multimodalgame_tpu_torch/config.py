"""Flags with CLI parity to the reference's gflags setup.

A copy of ``multimodalgame_tpu/config.py``'s flag registry, presets and
layered resolution, with identical flag names and defaults, so that a
``-log_load`` JSON dump written by either package (or by the reference)
configures the port: ``log_load`` JSON -> preset -> CLI overrides, then
the derived default paths (reference model.py:1744-1810).

Accepted CLI syntaxes: ``-name value``, ``--name value``, ``-name=value``,
bare booleans ``-name`` and the negated form ``-noname``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence


class FlagError(ValueError):
    pass


@dataclass
class FlagDef:
    name: str
    type: str  # "string" | "boolean" | "integer" | "float" | "enum"
    default: Any
    choices: Optional[List[str]] = None
    help: str = ""

    def parse(self, raw: str) -> Any:
        if self.type == "string":
            return raw
        if self.type == "enum":
            if self.choices and raw not in self.choices:
                raise FlagError(
                    f"flag --{self.name}: value {raw!r} not in {self.choices}")
            return raw
        if self.type == "integer":
            return int(raw)
        if self.type == "float":
            return float(raw)
        if self.type == "boolean":
            low = raw.lower()
            if low in ("true", "t", "1", "yes"):
                return True
            if low in ("false", "f", "0", "no"):
                return False
            raise FlagError(f"flag --{self.name}: bad boolean {raw!r}")
        raise FlagError(f"unknown flag type {self.type}")


class Flags:
    """Attribute namespace holding flag values (the ``FLAGS`` object)."""

    def __init__(self, defs: Dict[str, FlagDef]):
        object.__setattr__(self, "_defs", defs)
        for d in defs.values():
            object.__setattr__(self, d.name, d.default)

    def __setattr__(self, name: str, value: Any) -> None:
        if name not in self._defs:
            raise FlagError(f"unknown flag: {name}")
        object.__setattr__(self, name, value)

    def flag_values_dict(self) -> Dict[str, Any]:
        return {n: getattr(self, n) for n in self._defs}

    # gflags-compatible alias used in reference model.py:1007
    FlagValuesDict = flag_values_dict


def _registry() -> Dict[str, FlagDef]:
    defs: Dict[str, FlagDef] = {}

    def define(name, type_, default, choices=None):
        defs[name] = FlagDef(name, type_, default, choices)

    # Debug settings (reference model.py:1641-1643)
    define("branch", "string", None)
    define("sha", "string", None)
    define("debug", "boolean", False)

    # Convenience settings (model.py:1646-1655)
    define("save_after", "integer", 1000)
    define("save_interval", "integer", 100)
    define("checkpoint", "string", None)
    define("conf_mat", "string", None)
    define("log_path", "string", "./logs")
    define("log_file", "string", None)
    define("eval_csv_file", "string", None)
    define("json_file", "string", None)
    define("log_load", "string", None)
    define("eval_only", "boolean", False)

    # Extract settings (model.py:1658-1659)
    define("binary_only", "boolean", False)
    define("binary_output", "string", None)

    # Performance settings (model.py:1662) and the JAX package's
    # extensions. They are read from a -log_load dump and accepted on the
    # CLI with identical names and defaults; serving on the port uses none
    # of them except through GameConfig (compute_dtype).
    define("cuda", "boolean", False)
    define("fast_driver", "boolean", True)
    define("random_seed", "integer", 0)
    define("compute_dtype", "enum", "float32", ["float32", "bfloat16"])
    define("mesh", "integer", 0)
    define("mesh_model", "integer", 0)
    define("coordinator", "string", None)
    define("num_processes", "integer", 1)
    define("process_id", "integer", 0)
    define("ckpt_format", "enum", "msgpack", ["msgpack", "orbax"])
    define("population", "integer", 8)
    define("lr_scales", "string", None)

    # Display settings (model.py:1665-1670)
    define("env", "string", "main")
    define("visdom", "boolean", False)
    define("use_alpha", "boolean", False)
    define("experiment_name", "string", None)
    define("log_interval", "integer", 50)
    define("log_dev", "integer", 1000)

    # Data settings (model.py:1673-1683)
    define("wv_type", "enum", "glove.6B", ["fake", "glove.6B", "none"])
    define("wv_dim", "integer", 100)
    define("descr_train", "string", "descriptions.csv")
    define("descr_dev", "string", "descriptions.csv")
    define("train_file", "string", "train.hdf5")
    define("dev_file", "string", "dev.hdf5")
    define("images", "enum", "mammal", ["cifar", "mammal"])
    define("glove_path", "string", "./glove.6B/glove.6B.100d.txt")
    define("shuffle_train", "boolean", True)
    define("shuffle_dev", "boolean", False)

    # Model settings (model.py:1686-1722)
    define("model_type", "enum", None,
           ["Fixed", "Adaptive", "FixedAttention", "AdaptiveAttention"])
    define("img_feat", "enum", "avgpool_512", ["layer4_2", "avgpool_512", "fc"])
    define("data_context", "enum", "fc", ["fc"])
    define("sender_mix", "enum", "sum", ["sum", "prod", "mou"])
    define("img_feat_dim", "integer", 4096)
    define("img_h_dim", "integer", 100)
    define("baseline_hid_dim", "integer", 500)
    define("sender_out_dim", "integer", 50)
    define("rec_hidden", "integer", 128)
    define("rec_out_dim", "integer", 1)
    define("rec_w_dim", "integer", 50)
    define("rec_s_dim", "integer", 1)
    define("use_binary", "boolean", True)
    define("ignore_receiver", "boolean", False)
    define("ignore_code", "boolean", False)
    # Defined-but-unused in the reference (softmax detach at model.py:441 is
    # unconditional); kept for flag-surface parity.
    define("block_y", "boolean", True)
    define("first_rec", "float", 0)
    define("flipout_rec", "float", None)
    define("flipout_sen", "float", None)
    define("flipout_dev", "boolean", False)
    define("s_prob_prod", "boolean", True)
    define("visual_attn", "boolean", False)
    define("attn_dim", "integer", 256)
    define("attn_extra_context", "boolean", False)
    define("attn_context_dim", "integer", 4096)
    define("desc_attn", "boolean", False)
    define("desc_attn_dim", "integer", 64)
    define("top_k_dev", "integer", 6)
    define("top_k_train", "integer", 6)

    # Optimization settings (model.py:1725-1732)
    define("optim_type", "enum", "RMSprop", ["Adam", "SGD", "RMSprop"])
    define("batch_size", "integer", 32)
    define("batch_size_dev", "integer", 50)
    define("learning_rate", "float", 1e-4)
    define("max_epoch", "integer", 500)
    define("entropy_s", "float", None)
    define("entropy_sen", "float", None)
    define("entropy_rec", "float", None)

    # Conversation settings (model.py:1735-1741)
    define("exchange_samples", "integer", 3)
    define("max_exchange", "integer", 3)
    define("fixed_exchange", "boolean", True)
    define("bit_flip", "boolean", False)
    define("corrupt_region", "string", None)

    for name, text in _HELP.items():
        defs[name].help = text
    return defs


# One-line descriptions shown by ``--help`` (the reference's gflags
# surface printed per-flag help).
_HELP = {
    "branch": "Git branch recorded in the flag dump for provenance.",
    "sha": "Git commit recorded in the flag dump for provenance.",
    "debug": "Arm debug checks: autograd anomaly detection and numpy "
             "floating-point errors raised as exceptions.",
    "save_after": "First step at which checkpoints (periodic and _best) "
                  "may be written.",
    "save_interval": "Write the periodic checkpoint every this many steps.",
    "checkpoint": "Checkpoint path; training auto-resumes when the file "
                  "exists. Default derived from log_path/experiment_name.",
    "conf_mat": "Confusion-matrix CSV path written by dev evaluation.",
    "log_path": "Directory for the log file and derived artifact paths.",
    "log_file": "Training log file; default <log_path>/<experiment_name>.log.",
    "eval_csv_file": "CSV written by -eval_only with the dev accuracy.",
    "json_file": "Path of the flag-dump JSON written at startup.",
    "log_load": "Load flag values from a previous run's JSON dump "
                "(explicit CLI flags still override).",
    "eval_only": "Evaluate the checkpoint on the dev set, write the eval "
                 "CSV, and exit.",
    "binary_only": "Extract exchanged binary messages to binary_output "
                   "and exit.",
    "binary_output": "bv.hdf5 output path for -binary_only.",
    "cuda": "Accepted for reference CLI compatibility; the port runs on "
            "the GPU unless its caller asks for the CPU.",
    "fast_driver": "Chunked device-side training driver: dataset staged "
                   "on the GPU, batches gathered there by index, one copy "
                   "to the host per log window. -nofast_driver selects the "
                   "per-batch host loop.",
    "random_seed": "Master PRNG seed for parameter init and sampling "
                   "streams.",
    "ckpt_format": "Checkpoint backend: msgpack (one file, atomic "
                   "rename) or orbax (async checkpoint directory). "
                   "Loading auto-detects the format from the path.",
    "compute_dtype": "Training conversation precision: bfloat16 runs the "
                     "conversation on bfloat16 copies of the float32 "
                     "parameters (optimizers, losses and evaluation stay "
                     "float32; phase A takes the plain sampler).",
    "mesh": "Data-parallel mesh size for training/serving (0 or 1 = "
            "single device, -1 = all visible devices), one process a "
            "device. batch_size and batch_size_dev must be divisible by "
            "it.",
    "mesh_model": "Tensor-parallel (model) axis size M of the training "
                  "driver: the -mesh ranks form an (N/M data, M model) "
                  "grid; M must divide -mesh and the batches split over "
                  "N/M. The sweep and serving refuse it.",
    "coordinator": "Multi-host coordinator address host:port "
                   "(torch.distributed, tcp://). Set with "
                   "-num_processes > 1.",
    "num_processes": "Number of processes in a multi-host job (one per "
                     "host, each spawning a rank per device of its share "
                     "of -mesh); 1 = single-process.",
    "process_id": "This process's index in a multi-host job (0-based; "
                  "process 0's first rank writes the shared artifacts).",
    "population": "Member count of the population sweep (python -m "
                  "multimodalgame_tpu_torch.sweep): N games trained as "
                  "one batched step.",
    "lr_scales": "Per-member learning-rate multipliers of the population "
                 "sweep, comma-separated, cycled over the members.",
    "env": "Visdom environment name.",
    "visdom": "Enable live Visdom plotting.",
    "use_alpha": "Dump messages as letter groups instead of 0/1 strings.",
    "experiment_name": "Run name; stems every derived artifact path.",
    "log_interval": "Steps between interval log windows.",
    "log_dev": "Steps between dev evaluations.",
    "wv_type": "Word-vector source for class descriptions: a GloVe file, "
               "random fake vectors, or none (rejected — dead in the "
               "reference).",
    "wv_dim": "Word-vector dimensionality.",
    "descr_train": "Class-description CSV (label_id,label,description) "
                   "for training.",
    "descr_dev": "Class-description CSV for dev evaluation.",
    "train_file": "HDF5 feature file for training.",
    "dev_file": "HDF5 feature file for dev evaluation.",
    "images": "Image source: packaged mammal features, or the CIFAR-10 "
              "test split's pixels read from ./cifar-10-batches-py "
              "(needs PIL).",
    "glove_path": "GloVe text file scanned when wv_type=glove.6B.",
    "shuffle_train": "Shuffle training batches each epoch (seed "
                     "11+epoch). Ignored for CIFAR, which always "
                     "shuffles.",
    "shuffle_dev": "Shuffle dev batches.",
    "model_type": "Preset configuration; overrides the preset-owned "
                  "model/conversation flags.",
    "img_feat": "Which packaged feature set feeds the sender.",
    "data_context": "Feature set concatenated as extra attention context "
                    "(attn_extra_context).",
    "sender_mix": "How the sender mixes its image and message "
                  "projections.",
    "img_feat_dim": "Dimensionality of the selected image features.",
    "img_h_dim": "Sender hidden size.",
    "baseline_hid_dim": "Hidden size of the two value-baseline MLPs.",
    "sender_out_dim": "Sender message width in bits (must equal "
                      "rec_w_dim).",
    "rec_hidden": "Receiver GRU hidden size.",
    "rec_out_dim": "Per-class prediction head output width.",
    "rec_w_dim": "Receiver query width in bits (must equal "
                 "sender_out_dim).",
    "rec_s_dim": "STOP-bit head width.",
    "use_binary": "Sampled binary channel trained with REINFORCE; false "
                  "= continuous messages, classification loss only.",
    "ignore_receiver": "Zero the receiver's query each turn.",
    "ignore_code": "Sender ignores the incoming query and reads only the "
                   "image.",
    "block_y": "Accepted for flag-surface parity; unused (the "
               "reference's softmax detach is unconditional).",
    "first_rec": "Fill value of the receiver's initial query message.",
    "flipout_rec": "Training-time bit-flip probability on receiver "
                   "messages.",
    "flipout_sen": "Training-time bit-flip probability on sender "
                   "messages.",
    "flipout_dev": "Apply flipout corruption at dev evaluation too.",
    "s_prob_prod": "Eval-mode STOP decision uses the cumulative product "
                   "of per-turn stop probabilities.",
    "visual_attn": "Sender attends over the 8x8 layer4_2 feature map.",
    "attn_dim": "Visual-attention scoring dimensionality.",
    "attn_extra_context": "Concatenate the data_context features into "
                          "attention scoring.",
    "attn_context_dim": "Dimensionality of the attention context "
                        "features.",
    "desc_attn": "Receiver attends over description words instead of "
                 "using CBOW means.",
    "desc_attn_dim": "Description-attention scoring dimensionality.",
    "top_k_dev": "k for top-k dev accuracy.",
    "top_k_train": "k for top-k training accuracy.",
    "optim_type": "Optimizer applied to all four agents.",
    "batch_size": "Training batch size.",
    "batch_size_dev": "Dev-evaluation batch size.",
    "learning_rate": "Learning rate for all four optimizers.",
    "max_epoch": "Number of training epochs.",
    "entropy_s": "Entropy-bonus weight on the STOP head (presets set "
                 "this).",
    "entropy_sen": "Entropy-bonus weight on sender messages.",
    "entropy_rec": "Entropy-bonus weight on receiver messages.",
    "exchange_samples": "Example conversations dumped per log window.",
    "max_exchange": "Maximum exchange steps per conversation.",
    "fixed_exchange": "Always run max_exchange steps (no adaptive STOP).",
    "bit_flip": "Flip the corrupt_region sender-message bits at eval.",
    "corrupt_region": "Bit-region spec like '0:3,5' for eval-time "
                      "corruption.",
}


def make_flags() -> Flags:
    return Flags(_registry())


def format_help(flags: Flags) -> str:
    """The ``--help`` listing: every flag with its help text, type and
    default."""
    out = [
        "usage: python -m multimodalgame_tpu_torch[.serve] [flags]",
        "",
        "Flag syntaxes (gflags-compatible): -flag value, --flag=value,",
        "-boolflag, -noboolflag.",
        "",
    ]
    for d in sorted(flags._defs.values(), key=lambda d: d.name):
        head = (f"  --[no]{d.name}" if d.type == "boolean"
                else f"  --{d.name}")
        if d.type == "enum" and d.choices:
            head += " <" + "|".join(d.choices) + ">"
        out.append(head)
        if d.help:
            out.append(f"      {d.help}")
        out.append(f"      ({d.type}; default: {d.default!r})")
    return "\n".join(out)


def parse_args(flags: Flags, argv: Sequence[str]) -> None:
    """Apply gflags-style CLI overrides in place.

    ``argv`` should exclude the program name (i.e. pass ``sys.argv[1:]``).
    """
    defs = flags._defs
    i = 0
    args = list(argv)
    while i < len(args):
        tok = args[i]
        if tok in ("-h", "-help", "--help", "-helpfull", "--helpfull"):
            print(format_help(flags))
            raise SystemExit(0)
        if not tok.startswith("-"):
            raise FlagError(f"unexpected positional argument: {tok!r}")
        name = tok.lstrip("-")
        inline: Optional[str] = None
        if "=" in name:
            name, inline = name.split("=", 1)

        negated = False
        if name not in defs and name.startswith("no") and name[2:] in defs \
                and defs[name[2:]].type == "boolean":
            name = name[2:]
            negated = True
        if name not in defs:
            raise FlagError(f"unknown flag: {tok}")
        d = defs[name]

        if inline is not None:
            # gflags rejects a value on the negated form (--noflag=value):
            # silently parsing it here would invert the user's negation
            # (-nofast_driver=true setting fast_driver=True).
            if negated:
                raise FlagError(
                    f"boolean flag -no{name} does not take a value "
                    f"(got {tok!r}); use -{name}={inline} or -no{name}")
            setattr(flags, name, d.parse(inline))
            i += 1
            continue
        if d.type == "boolean":
            # Bare boolean (``-use_binary``) or with an explicit value
            # (``-use_binary true``). gflags accepts both.
            if not negated and i + 1 < len(args) and \
                    args[i + 1].lower() in ("true", "false", "t", "f",
                                            "1", "0", "yes", "no"):
                setattr(flags, name, d.parse(args[i + 1]))
                i += 2
            else:
                setattr(flags, name, not negated)
                i += 1
            continue
        if i + 1 >= len(args):
            raise FlagError(f"flag {tok} expects a value")
        setattr(flags, name, d.parse(args[i + 1]))
        i += 2


# ---------------------------------------------------------------------------
# Preset model configurations (reference model.py:1595-1636).
# Dispatched by name via a dict rather than the reference's ``eval()``.
# ---------------------------------------------------------------------------

def _fixed(f: Flags) -> None:
    f.img_feat = "avgpool_512"
    f.img_feat_dim = 512
    f.fixed_exchange = True
    f.visual_attn = False


def _adaptive(f: Flags) -> None:
    f.img_feat = "avgpool_512"
    f.img_feat_dim = 512
    f.fixed_exchange = False
    f.visual_attn = False


def _fixed_attention(f: Flags) -> None:
    f.img_feat = "layer4_2"
    f.img_feat_dim = 512
    f.fixed_exchange = True
    f.visual_attn = True
    f.attn_dim = 256
    f.attn_extra_context = True
    f.attn_context_dim = 1000


def _adaptive_attention(f: Flags) -> None:
    f.img_feat = "layer4_2"
    f.img_feat_dim = 512
    f.fixed_exchange = False
    f.visual_attn = True
    f.attn_dim = 256
    f.attn_extra_context = True
    f.attn_context_dim = 1000


PRESETS = {
    "Fixed": _fixed,
    "Adaptive": _adaptive,
    "FixedAttention": _fixed_attention,
    "AdaptiveAttention": _adaptive_attention,
}


def finalize_flags(flags: Flags, argv: Sequence[str] = ()) -> Flags:
    """Layered resolution + derived defaults (reference ``default_flags()``,
    model.py:1744-1810).

    Order: ``log_load`` JSON -> re-apply CLI -> preset -> re-apply CLI ->
    invariants -> derived names/paths.

    Reference-parity quirk (model.py:1744-1754 has the same order): when
    the ``log_load`` JSON carries a ``model_type``, the preset re-applies
    AFTER the JSON restore, so preset-owned flags the original run
    overrode on its CLI (e.g. ``-attn_dim 512`` under FixedAttention)
    revert to preset values unless re-passed on the new CLI. Reloading a
    customized run therefore needs the custom flags repeated (exactly as
    the reference requires).
    """
    if flags.log_load:
        with open(flags.log_load) as f:
            log_flags = json.load(f)
        for k, v in log_flags.items():
            if k in flags._defs:
                object.__setattr__(flags, k, v)
        parse_args(flags, argv)  # CLI overrides win over the JSON.

    if flags.model_type:
        PRESETS[flags.model_type](flags)
        parse_args(flags, argv)  # CLI overrides win over the preset.

    if flags.sender_out_dim != flags.rec_w_dim:
        # The reference asserts this (model.py:1756-1757); raise so the
        # guard survives ``python -O``.
        raise ValueError("Both sender and receiver should communicate "
                         "with same dim vectors for now.")

    if not flags.use_binary:
        flags.exchange_samples = 0
    if flags.exchange_samples > flags.batch_size:
        # The log window samples its dumped conversations from one
        # training batch; more samples than rows would die at the first
        # boundary with an opaque reshape/index error (in the reference
        # too, model.py:1411-1518).
        raise ValueError(
            f"-exchange_samples {flags.exchange_samples} exceeds "
            f"-batch_size {flags.batch_size}: conversation dumps sample "
            "from a single training batch")

    if not flags.experiment_name:
        timestamp = str(int(time.time()))
        flags.experiment_name = "{}-so_{}-wv_{}-bs_{}-{}".format(
            flags.images, flags.sender_out_dim, flags.wv_dim,
            flags.batch_size, timestamp)

    join = os.path.join
    if not flags.conf_mat:
        flags.conf_mat = join(flags.log_path,
                              flags.experiment_name + ".conf_mat.txt")
    if not flags.log_file:
        flags.log_file = join(flags.log_path, flags.experiment_name + ".log")
    if not flags.eval_csv_file:
        flags.eval_csv_file = join(flags.log_path,
                                   flags.experiment_name + ".eval.csv")
    if not flags.json_file:
        flags.json_file = join(flags.log_path, flags.experiment_name + ".json")
    if not flags.checkpoint:
        flags.checkpoint = join(flags.log_path, flags.experiment_name + ".pt")
    if not flags.binary_output:
        flags.binary_output = join(flags.log_path,
                                   flags.experiment_name + ".bv.hdf5")

    if flags.debug:
        import numpy as np
        np.seterr(all="raise")

    flags.glove_path = os.path.expanduser(flags.glove_path)
    return flags


def flags_from_argv(argv: Optional[Sequence[str]] = None) -> Flags:
    """Build, parse, and finalize flags — the reference ``__main__`` path
    (model.py:1813-1818)."""
    if argv is None:
        argv = sys.argv[1:]
    flags = make_flags()
    parse_args(flags, argv)
    finalize_flags(flags, argv)
    return flags
