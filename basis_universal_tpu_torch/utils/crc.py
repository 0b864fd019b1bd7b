"""Copy of `basis_universal_tpu/utils/crc.py`.

CRC16 used by the .basis container.

The reference's crc16 (transcoder/basisu_transcoder.cpp:340-353) is
CRC-16/XMODEM (poly 0x1021, MSB-first) wrapped in a pre/post complement:
    crc16(data, crc) = ~xmodem(data, init=~crc)
Python's binascii.crc_hqx IS CRC-16/XMODEM with a caller-provided init,
so the whole thing is a single C call — no Python byte loop.
"""

import binascii


def crc16(data: bytes, crc: int = 0) -> int:
    return (~binascii.crc_hqx(bytes(data), (~crc) & 0xFFFF)) & 0xFFFF
