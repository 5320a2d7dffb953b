"""mrijax_torch — the PyTorch/CUDA port of mrijax, grown slice by slice.

The JAX package ``mrijax`` is the reference and stays as it is; this package
imports ``torch`` only, never ``jax``, ``flax`` or ``mrijax``. Sub-packages
and functions keep the names of their counterparts (``ops``, ``kernels``,
``models``, ``diffusion``, ``train``, ``generate``), and public functions keep
the channels-last layouts of the JAX package.

Ported so far: the 3D latent-diffusion family — generation (``UNet3D``
sampling followed by ``VAE3D`` decode, ``generate.generate_3d_volumes``, and
``generate.Vae3dDiagnostics``) and training (``train``: train state with fp32
Adam and EMA, the cached-latent, latent-diffusion and VAE steps) — with
hand-written CUDA kernels for fused GroupNorm+SiLU and for the flash-attention
forward and backward; the training runtime (``train.Trainer``,
``io.CheckpointManager``, ``config``, ``obs`` and the builders of
``train.experiments``); the 2D slice-conditioned and 2.5D multimodal families
(``models.UNet2D``, the samplers of ``generate`` with classifier-free
guidance and the pseudo-3D generators, ``train.make_diffusion_train_step``);
``io.torch_convert`` (reference PyTorch checkpoints) and ``io.images``; and
the data package (``data``: NIfTI, datasets, splits, packed shards, the
batch loader) with the experiment drivers (``train.run_experiment``), which
train every family from BraTS files on disk. Entry points take ``device=``
and default to ``"cuda"``; the kernels are compiled from
``mrijax_torch/csrc`` at their first CUDA call, and the NIfTI reader from
``csrc/mrijax_io.cpp`` at its first use, so importing the package needs
neither a compiler nor a GPU.
"""

__version__ = "0.1.0"
