"""CLI entry point: ``python -m multimodalgame_tpu_torch <flags>``.

The port of ``multimodalgame_tpu/cli.py``, a drop-in for the reference's
``python model.py <flags>`` (model.py:1813-1820): the same flag names and
syntaxes, presets, derived paths and ``-eval_only`` / ``-binary_only``
modes (``config.py:flags_from_argv``, ``train.py:run``). It runs on
``cuda``; ``main(argv, device="cpu")`` runs the plain PyTorch path on
the CPU.
"""

from __future__ import annotations

import sys

from multimodalgame_tpu_torch.config import flags_from_argv


def main(argv=None, device=None) -> None:
    flags = flags_from_argv(argv)
    from multimodalgame_tpu_torch.train import run
    run(flags, device=device)


if __name__ == "__main__":
    main(sys.argv[1:])
