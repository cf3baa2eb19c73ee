"""MultimodalGame on PyTorch and CUDA: the port of ``multimodalgame_tpu``
to one NVIDIA H100 (Hopper, ``sm_90a``).

The layout mirrors the JAX package module by module, so each counterpart
sits at the same path. This package imports ``torch``, ``numpy`` and the
standard library only; ``h5py`` and ``nltk`` are imported lazily by the
functions that read HDF5 files or tokenize text.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise
(:func:`multimodalgame_tpu_torch.utils.device.resolve_device`).

Covered so far, for every preset (the attention ones included),
``-desc_attn``, the ``mou`` mix and ``-flipout_dev``: ``python -m
multimodalgame_tpu_torch`` (``cli.py``, ``train.py``: the training
driver ``game/driver.py``, dev evaluation ``game/fast_eval.py`` and
``eval.py``, extraction ``extract.py``, checkpoints with optimizer state
``utils/checkpoint.py``), serving (``serve.py``) and the training steps
(``game/train.py``, ``game/fast_train.py``). For the configs the JAX
kernel covers (``ops/cuda_exchange.py:supports_config``) the whole
conversation runs in one hand-written CUDA kernel
(``csrc/fused_exchange.cu``): rounded in eval mode, sampled
(Philox4x32-10, ``ops/philox.py``) in train mode, where it is phase A of
every ``fast="kernel"`` step. The others run it in plain PyTorch.
"""

__version__ = "0.1.0"
