"""PyTorch/CUDA port of ``sparse_coding_tpu`` for one NVIDIA H100.

Module paths mirror the JAX package so each counterpart is easy to find.
The port imports torch and numpy only — never jax, flax, optax, or the JAX
package itself — so a host with a GPU needs no JAX install.

Numerics: ``compute_dtype="float32"`` means true fp32, as in the JAX
package, so TF32 is switched off for matmuls and cuDNN on import.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``cuda``. A
    missing card raises — entry points never fall back to the CPU; the
    CPU runs only when the caller asks for it (``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
