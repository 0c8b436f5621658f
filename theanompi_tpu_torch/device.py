"""Device resolution and the numeric policy of the port, in one place.

``resolve_device`` is what every entry point calls first. It returns a
CUDA device unless the caller explicitly asked for the CPU, and it
RAISES when no card is present and the CPU was not requested — a run
that silently continued on the CPU would report CPU numbers as if they
were the card's.

TF32 policy: both ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are set to False here. cuDNN's
default runs float32 convolutions in TF32 (about three decimal digits),
which would silently change every fp32 recipe and the fp32 parity runs
against the reference. Recipes that want low precision say so with
``Recipe.compute_dtype`` (AlexNet computes in bfloat16), where TF32
does not apply.

Determinism: ``torch.backends.cudnn.deterministic`` is set to True
here. Left to itself, cuDNN may pick a float32 convolution algorithm
that sums with atomics (WRN-28-10's fp32 weight gradients), so two runs
of one step differ in their last bits, and a resumed or a captured run
would not equal the uninterrupted eager one, which the port promises (as
the reference's compiled steps give).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def set_precision_policy() -> None:
    """float32 means float32 on the card, and cuDNN's algorithms are
    deterministic (see the module docstring)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> the current CUDA device, or raise when there is none.

    ``"cpu"`` is honoured only because the caller asked for it (tests,
    ``--device cpu``). Any CUDA request without a card raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; this entry point runs on the "
                "card unless asked otherwise — pass device='cpu' "
                "(--device cpu on the CLI) to run on the CPU"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    set_precision_policy()
    return device
