"""mrijax_torch — the PyTorch/CUDA port of mrijax, grown slice by slice.

The JAX package ``mrijax`` is the reference and stays as it is; this package
imports ``torch`` only, never ``jax``, ``flax`` or ``mrijax``. Sub-packages
and functions keep the names of their counterparts (``ops``, ``kernels``,
``models``, ``diffusion``, ``generate``), and public functions keep the
channels-last layouts of the JAX package.

Ported so far: the 3D latent-diffusion generation path — ``UNet3D`` DDIM
sampling followed by ``VAE3D`` decode (``generate.generate_3d_volumes``) —
with hand-written CUDA kernels for fused GroupNorm+SiLU and the
flash-attention forward. Entry points take ``device=`` and default to
``"cuda"``; the kernels are compiled from ``mrijax_torch/csrc`` at their
first CUDA call, so importing the package needs neither ``nvcc`` nor a GPU.
"""

__version__ = "0.1.0"
