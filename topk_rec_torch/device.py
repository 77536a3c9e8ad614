"""Device resolution and the fp32 matmul settings of the port.

The JAX package runs its eval matmuls at ``Precision.HIGHEST``
(``topk_rec_tpu/eval/device.py:95-98``, ``ops/topk_pallas.py:133-135``),
i.e. true fp32. On the H100 a float32 ``torch.matmul`` may use TF32 when
``allow_tf32`` is set, which keeps ~3 decimal digits and flips near-tied
rankings, so :func:`resolve_device` turns TF32 off and checks that it is
off before any tensor reaches the card.
"""

from __future__ import annotations

import torch


def set_fp32_matmul() -> None:
    """Make float32 matmuls and convolutions run in true fp32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 could not be turned off")


def resolve_device(name="cuda") -> torch.device:
    """``torch.device`` for ``name``; raises when CUDA is asked for and absent.

    Never falls back to the CPU by itself: a run on the CPU is asked for
    explicitly (``--device cpu``).
    """
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is not available "
                "(pass --device cpu / device='cpu' to run on the CPU)"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
    set_fp32_matmul()
    return dev
