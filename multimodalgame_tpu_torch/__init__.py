"""MultimodalGame on PyTorch and CUDA: the port of ``multimodalgame_tpu``
to one NVIDIA H100 (Hopper, ``sm_90a``).

The layout mirrors the JAX package module by module, so each counterpart
sits at the same path. This package imports ``torch``, ``numpy`` and the
standard library only; ``h5py`` and ``nltk`` are imported lazily by the
functions that read HDF5 files or tokenize text.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise
(:func:`multimodalgame_tpu_torch.utils.device.resolve_device`).

Covered so far, for the non-attention game: ``python -m
multimodalgame_tpu_torch`` (``cli.py``, ``train.py``: the training
driver ``game/driver.py``, dev evaluation ``game/fast_eval.py`` and
``eval.py``, extraction ``extract.py``, checkpoints with optimizer state
``utils/checkpoint.py``), serving (``serve.py``) and the training steps
(``game/train.py``, ``game/fast_train.py``). The whole conversation runs
in one hand-written CUDA kernel (``ops/cuda_exchange.py``,
``csrc/fused_exchange.cu``): rounded in eval mode, sampled
(Philox4x32-10, ``ops/philox.py``) in train mode, where it is phase A of
every ``fast="kernel"`` step.
"""

__version__ = "0.1.0"
