"""PyTorch/CUDA port of the SPB training system for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``config``, ``configs``, ``kernels``, ``models``, ``core``,
``optim``, ``dist``, ``engine``, ``data``, ``launch``) and imports nothing
of it.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`repro_torch.device.resolve_device`).
"""
