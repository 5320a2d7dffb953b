"""Milliseconds of the current stream that the attention core of every block
(the flash kernel with the copies that pad the head dim 72 to 128 and cut it
back) of the DiT denoiser takes a denoise step: the program's span
``dit.flash``, summed over the traced segment of a gen cell and divided by
its steps."""

from benchmark_h100.declared_spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "gen", "mrijax_torch.models.dit3d", "dit.flash")
