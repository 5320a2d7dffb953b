"""Milliseconds of the current stream that the attention branch of every block
(LN, modulate, qkv, the attention core, proj and the gated residual) of the
DiT denoiser takes a denoise step: the program's span ``dit.msa``, summed
over the traced segment of a gen cell and divided by its steps."""

from benchmark_h100.declared_spans import stream_ms


def read(ctx):
    return stream_ms(ctx, "gen", "mrijax_torch.models.dit3d", "dit.msa")
