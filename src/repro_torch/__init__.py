"""CloudSim's tensorized simulator in PyTorch, for one NVIDIA H100.

A port of the JAX package ``repro`` (the reference it is tested against),
module for module: ``core/`` holds the simulator, ``ft/`` the straggler
study on it, ``models/``, ``configs/`` and ``serve/`` the LM serving
stack, ``kernels/`` the hand-written CUDA kernels with their plain
PyTorch versions.  Entry points
run on the CUDA device unless the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device  # noqa: F401
