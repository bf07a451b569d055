"""tpu_mednet_torch: the PyTorch/CUDA port of tpu_mednet for NVIDIA Hopper.

The JAX package ``tpu_mednet`` is the reference; this package mirrors its
module paths and imports ``torch`` and numpy only, never JAX or
``tpu_mednet``.  Modules take logical NCDHW tensors stored as
``torch.channels_last_3d`` (physically the JAX package's (N, X, Y, Z, C)).

Every entry point takes an explicit ``device``; ``None`` means ``cuda`` and
raises when CUDA is absent.  The CPU is used only when the caller passes it.
The hand-written CUDA kernels (``csrc/``) are built with ``nvcc`` on first
use; on a CPU tensor each kernel wrapper runs its plain PyTorch version.
"""

from tpu_mednet_torch._device import resolve_device

__all__ = ["resolve_device"]
