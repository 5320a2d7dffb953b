"""Hand-written CUDA kernels for Hopper with plain PyTorch versions beside them.

A wrapper launches its kernel for a CUDA tensor (building the library from
``mrijax_torch/csrc`` on first use) and uses the plain version only for a
tensor that lies on the CPU. Import the modules themselves
(``mrijax_torch.kernels.groupnorm``, ``mrijax_torch.kernels.flash_attention``):
nothing is re-exported here, so that the module ``flash_attention`` is not
shadowed by the function of the same name.
"""
