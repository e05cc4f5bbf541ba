"""ctc_pytorch_tpu_torch — the PyTorch/CUDA port of ``ctc_pytorch_tpu``.

Module paths mirror the JAX package (``models/rnn.py`` here is the
counterpart of ``ctc_pytorch_tpu/models/rnn.py`` there), so each function
has one obvious reference.  The port imports torch and numpy only: the
host-side modules it needs from the JAX package (config, vocab, Kaldi I/O,
dataset, batching, scoring) are copies kept here.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
Where a module holds a hand-written CUDA kernel (``ops/lstm_bidir.py``,
``ops/gru_bidir.py``, their ``_train`` siblings and ``ops/ctc_loss.py``), a
CUDA tensor goes through the kernel and a CPU tensor through its plain
PyTorch twin; asking for ``cuda`` without a card raises.
"""

from __future__ import annotations

__version__ = "0.1.0"

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises when CUDA is asked for
    and no card is present, so no entry point continues on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but torch sees no CUDA "
            "device; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
