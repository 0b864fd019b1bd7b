"""ETC1S's control: each texture assigned to the codebooks the program built
for the next texture of its call, through the program's own global-codebook
path, and written as a normal file. It breaks "codebooks built for each
texture"; it is the step a later change could take to skip the per-texture
codebook search."""

import numpy as np


def encoder(params):
    from basis_universal_tpu_torch import compressor
    from basis_universal_tpu_torch.codecs.etc1s import frontend

    from ..reference import container, etc1s

    def encode(textures):
        own = compressor.compress_batch(textures, params)
        out = []
        for i, tex in enumerate(textures):
            donor = container.Basis(own[(i + 1) % len(own)].basis_data)
            h = donor.header
            c5, inten, patterns = etc1s.decode_palettes(
                h["total_endpoints"], donor.section("endpoint_cb"),
                h["total_selectors"], donor.section("selector_cb"))
            slices = compressor._prepare_slices([tex], params)
            blocks = np.concatenate([s["blocks"] for s in slices], 0)
            fe = frontend.compress_with_global_codebooks(
                blocks, c5, inten, patterns, effort=params.effort,
                perceptual=params.perceptual_metric, device=params.device)
            out.append(compressor._assemble(slices, fe, params))
        return out
    return encode
