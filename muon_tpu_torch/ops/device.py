"""Device resolution for the compute layer (counterpart of muon_tpu/ops/device.py).

The port runs every device op on an explicit ``torch.device``. ``"auto"``
(or None) takes the first CUDA device when one is present and the CPU
otherwise; asking for ``"cuda"`` without a card raises instead of carrying
on silently on the CPU.

Matmul precision: the port's float32 products (the CholeskyQR Grams, the
Rayleigh-Ritz Gram, Q·Ub) are held to the JAX reference at float32
tolerance, so they must run in full float32. On a CUDA device that is
PyTorch's default (``torch.backends.cuda.matmul.allow_tf32`` False,
``torch.get_float32_matmul_precision() == "highest"``); TF32 keeps about
three decimal digits and would break the parity the tests state.
:func:`resolve_device` refuses a CUDA device while TF32 matmuls are on.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["resolve_device", "check_matmul_precision"]

DeviceLike = Union[None, str, torch.device]


def check_matmul_precision() -> None:
    """Raise if float32 matmuls on CUDA would run in TF32."""
    if (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "muon_tpu_torch needs full float32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')"
        )


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/``"auto"`` → cuda if available else cpu; ``"cuda"``/``"cpu"``
    (or a ``torch.device``) as given. A CUDA request without a card raises."""
    if device is None or device == "auto":
        dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {dev} requested but torch.cuda.is_available() is False"
            )
        check_matmul_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
