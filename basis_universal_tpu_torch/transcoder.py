""".basis / .KTX2 transcoder fronts whose re-encodes run on the port.

The reference transcoder (`basis_universal_tpu/transcoder.py`) is host code
except for two re-encode calls of the UASTC LDR 4x4 engine, which reach the
JAX encoders: the ETC1 target (`_reencode_etc1`, an ETC1S `encode_blocks`
at radius 1, also the colour half of ETC2_RGBA) and the ASTC 4x4 re-encode
of decoded pixels (the UASTC encoder at effort 2). `UastcTranscodeEngine`
below sends both to the port's encoders on a torch device; the two fronts
install it for UASTC LDR 4x4 files and are the reference's transcoders in
everything else.
"""

import numpy as np
import torch

from basis_universal_tpu import transcoder as ref
from basis_universal_tpu.formats.constants import BasisTexFormat
from basis_universal_tpu.formats.constants import TranscoderTextureFormat as TF
from basis_universal_tpu.ops import etc1 as etc1_ops
from basis_universal_tpu.utils.errors import guard_parse

from .codecs.etc1s.frontend import resolve_device
from .codecs.uastc import encode as uastc_encode
from .ops import etc1s_encode


class UastcTranscodeEngine(ref.UastcTranscodeEngine):
    """UASTC LDR 4x4 decode + conversion; the re-encodes run on `device`."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def _reencode_etc1(self, px):
        """ETC1 blocks (N, 8) of decoded RGBA pixels px (N, 16, 4)."""
        rgb = torch.as_tensor(np.ascontiguousarray(px[..., :3],
                                                   dtype=np.float32))
        with etc1s_encode.exact_matmuls():
            res = etc1s_encode.encode_blocks(rgb.to(self.device), radius=1)
        got = {k: res[k].cpu().numpy() for k in ("color5", "inten",
                                                 "selectors")}
        n = px.shape[0]
        idx = np.arange(n).reshape(1, n)
        return etc1_ops.pack_etc1_blocks(
            idx, idx, got["color5"].astype(np.uint8),
            got["inten"].astype(np.uint8),
            got["selectors"].astype(np.uint8)).reshape(n, 8)

    def convert_rgba(self, fmt, rgba: np.ndarray, nbx: int, nby: int,
                     orig_width: int, orig_height: int) -> np.ndarray:
        if fmt == TF.ASTC_4x4_RGBA:
            from basis_universal_tpu.codecs.uastc import astc_pack

            ub = uastc_encode.encode_blocks(
                rgba.reshape(-1, 16, 4).astype(np.float32), effort=2,
                has_alpha=True, device=self.device)
            return astc_pack.uastc_blocks_to_astc(ub).reshape(nby, nbx, 16)
        return super().convert_rgba(fmt, rgba, nbx, nby, orig_width,
                                    orig_height)


class BasisTranscoder(ref.BasisTranscoder):
    """The reference's .basis transcoder; UASTC LDR 4x4 files get the
    port's engine on `device`."""

    def __init__(self, data: bytes, device="cuda"):
        super().__init__(data)
        self.device = resolve_device(device)

    @guard_parse
    def start_transcoding(self):
        if (self._engine is None
                and self.tex_format == BasisTexFormat.UASTC_LDR_4x4):
            self._engine = UastcTranscodeEngine(self.device)
        return super().start_transcoding()


class Ktx2Transcoder(ref.Ktx2Transcoder):
    """The reference's .KTX2 transcoder; UASTC LDR 4x4 files get the port's
    engine on `device`."""

    def __init__(self, data: bytes, device="cuda"):
        super().__init__(data)
        self.device = resolve_device(device)

    @guard_parse
    def start_transcoding(self):
        if (self._engine is None and self.file.basis_tex_format()
                == BasisTexFormat.UASTC_LDR_4x4):
            self._engine = UastcTranscodeEngine(self.device)
        return super().start_transcoding()
