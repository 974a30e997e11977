"""Device resolution for the compute layer (counterpart of muon_tpu/ops/device.py).

The port runs every device op on an explicit ``torch.device``. ``"auto"``
(or None) means the card: the current CUDA device, and an error when there
is none. The port runs on the CPU only when the caller asks for it with
``device="cpu"`` (the tests do); it never carries on there silently.

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

import numpy as np
import torch

__all__ = ["resolve_device", "check_matmul_precision", "dense_to_tensor", "on_card"]

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
    """``None``/``"auto"`` → cuda; ``"cuda"``/``"cpu"`` (or a
    ``torch.device``) as given. A CUDA request without a card raises, and
    so does the default: the CPU is taken only when asked for."""
    if device is None or device == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device (torch.cuda.is_available() is False); pass "
                'device="cpu" to run on the CPU'
            )
        dev = torch.device("cuda")
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


def on_card(t: torch.Tensor) -> bool:
    """How a kernel wrapper routes: False for a CPU tensor (its plain version
    runs), True for a CUDA tensor (it launches its kernel); raises for any
    other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def dense_to_tensor(arr, device: DeviceLike = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A dense array (numpy, anything ``np.asarray`` takes, or a tensor) as a
    contiguous ``dtype`` tensor on ``device`` (counterpart of the
    reference's ``dense_to_device``). It keeps no registry of uploaded
    arrays and pins nothing: each call copies."""
    device = resolve_device(device)
    if not torch.is_tensor(arr):
        arr = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))
    return arr.to(device=device, dtype=dtype).contiguous()
