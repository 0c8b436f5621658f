"""theanompi_tpu_torch — the PyTorch/CUDA port of ``theanompi_tpu``.

The JAX package (``theanompi_tpu``) is the reference; this package
re-implements its main path in PyTorch for one NVIDIA Hopper card:
BSP data-parallel training of the CNN zoo (AlexNet first), with every
TPU kernel on that path rewritten by hand as a CUDA kernel for
``sm_90a`` (``csrc/``, built with ``nvcc`` at first use and bound with
``ctypes`` — see ``ops/kernels.py``).

Conventions kept from the reference so the two packages compare like
with like:

- images are NHWC float32 at every public function;
- parameters are nested dicts under the reference's names
  (``{"00_conv1": {"w", "b"}, ...}``); conv kernels are stored OIHW
  internally (``bridge.py`` converts to and from the reference's HWIO);
- randomness comes from explicit ``torch.Generator``s, never the global
  RNG.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); without a card and without that
request they raise (``device.resolve_device``).

Session API::

    from theanompi_tpu_torch import BSP
    BSP().init(devices=1, modelfile="alexnet", modelclass="AlexNet",
               blocking=True, fused_update=True, max_steps=10)

This package never imports ``jax`` or ``theanompi_tpu``.
"""

__version__ = "0.1.0"

from theanompi_tpu_torch.launch.session import BSP, SyncRule  # noqa: E402,F401

__all__ = ["BSP", "SyncRule", "__version__"]
