"""Video without codec libraries: baseline JPEG encoding with numpy only
and Motion-JPEG inside an AVI container.  Counterpart of
`cips3d_tpu/utils/video.py` (`encode_jpeg`, `write_mjpeg_avi`,
`read_mjpeg_avi`, `write_video`), which asks PIL for the JPEGs.

The encoder: JFIF, 8-bit YCbCr (the JFIF colour transform), one scan with
the three components interleaved and no subsampling, the IJG quantization
tables scaled by quality as libjpeg (and so PIL) scales them, a float DCT
with round-to-nearest quantization, and the standard Huffman tables of
ITU T.81 Annex K.  Images whose sides are not multiples of 8 are padded by
repeating the edge pixels, as libjpeg pads them.

The container is the JAX package's minimal AVI 1.0: RIFF('AVI ') with an
'hdrl' list (avih + one 'vids'/'MJPG' stream), a 'movi' list of '00dc'
frame chunks and an 'idx1' keyframe index; it plays in VLC, mpv, ffplay
and QuickTime.  The port has no mp4 encoder, so `write_video` always
writes this container (an ``.mp4`` path becomes ``.avi``), and it has no
JPEG decoder, so `read_mjpeg_avi` returns each frame's JPEG bytes.
"""

from __future__ import annotations

import struct
from typing import Iterable, List

import numpy as np

AVIF_HASINDEX = 0x00000010
AVIIF_KEYFRAME = 0x00000010

_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]).reshape(8, 8)
_CHROMA_Q = np.full((8, 8), 99)
_CHROMA_Q[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99], [47, 66, 99, 99]]

# zigzag scan: position k of the scan reads natural index _ZIGZAG[k] of the 8x8 block
_ZIGZAG = np.array(sorted(range(64), key=lambda i: (
    (i // 8 + i % 8), (i % 8 if (i // 8 + i % 8) % 2 == 0 else i // 8))))

_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6"
    "c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _dct_matrix() -> np.ndarray:
    k, n = np.arange(8)[:, None], np.arange(8)[None, :]
    d = np.cos((2 * n + 1) * k * np.pi / 16) * 0.5
    d[0] = np.sqrt(1.0 / 8)
    return d


_DCT = _dct_matrix()


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` of a base table, clamped to the
    baseline range 1..255."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _huffman_codes(spec):
    """{symbol: (code, length)} of a (bits, values) table (T.81 Annex C)."""
    bits, vals = spec
    codes, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


_TABLES = [(_huffman_codes(_DC_LUMA), _huffman_codes(_AC_LUMA)),
           (_huffman_codes(_DC_CHROMA), _huffman_codes(_AC_CHROMA))]


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", 0xFF00 | marker, len(payload) + 2) + payload


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(H, W) -> (H/8 * W/8, 8, 8) in raster order of the blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)


def encode_jpeg(frame: np.ndarray, quality: int = 92) -> bytes:
    """HWC uint8 RGB (or HW grey) -> baseline JPEG bytes, 4:4:4."""
    img = np.asarray(frame, dtype=np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    h, w = img.shape[:2]
    ph, pw = -h % 8, -w % 8
    x = np.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge").astype(np.float64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0,
              0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0]
    qts = [quant_table(_LUMA_Q, quality), quant_table(_CHROMA_Q, quality)]
    coefs = []
    for c, plane in enumerate(planes):
        blk = _blocks(plane - 128.0)
        f = np.einsum("uk,bkl,vl->buv", _DCT, blk, _DCT)
        q = np.rint(f / qts[min(c, 1)]).astype(np.int64)
        coefs.append(q.reshape(-1, 64)[:, _ZIGZAG])

    # entropy coding: bits collected into a Python int, 8 bits at a time into a bytearray
    out = bytearray()
    acc, nacc = 0, 0

    def put(code, length):
        nonlocal acc, nacc
        acc = (acc << length) | code
        nacc += length
        while nacc >= 8:
            nacc -= 8
            byte = (acc >> nacc) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
        acc &= (1 << nacc) - 1

    def put_value(v):
        size = int(abs(v)).bit_length()
        return size, (v if v >= 0 else v + (1 << size) - 1)

    pred = [0, 0, 0]
    for i in range(coefs[0].shape[0]):
        for c in range(3):
            dc_codes, ac_codes = _TABLES[min(c, 1)]
            zz = coefs[c][i]
            diff = int(zz[0]) - pred[c]
            pred[c] = int(zz[0])
            size, bits = put_value(diff)
            put(*dc_codes[size])
            if size:
                put(bits, size)
            nz = np.flatnonzero(zz[1:]) + 1
            last = 0
            for k in nz.tolist():
                run = k - last - 1
                while run > 15:
                    put(*ac_codes[0xF0])
                    run -= 16
                size, bits = put_value(int(zz[k]))
                put(*ac_codes[(run << 4) | size])
                put(bits, size)
                last = k
            if last != 63:
                put(*ac_codes[0x00])
    if nacc:   # pad the last byte with ones
        put((1 << (8 - nacc)) - 1, 8 - nacc)

    header = b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tid, qt in enumerate(qts):
        header += _segment(0xDB, bytes([tid]) + bytes(qt.reshape(-1)[_ZIGZAG].tolist()))
    header += _segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + bytes(
        [1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for cls, tid, (bits, vals) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA), (0, 1, _DC_CHROMA),
                                   (1, 1, _AC_CHROMA)):
        header += _segment(0xC4, bytes([(cls << 4) | tid]) + bytes(bits) + bytes(vals))
    header += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return header + bytes(out) + b"\xff\xd9"


# ---------------------------------------------------------------- MJPEG-AVI

def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(list_type: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", list_type + payload)


def write_mjpeg_avi(frames: Iterable[np.ndarray], out_path: str, fps: int = 25,
                    quality: int = 92) -> str:
    """Write HWC uint8 RGB frames as an MJPEG AVI.  Returns ``out_path``."""
    frames = [np.asarray(f, dtype=np.uint8) for f in frames]
    if not frames:
        raise ValueError("no frames")
    jpegs: List[bytes] = [encode_jpeg(f, quality) for f in frames]
    h, w = frames[0].shape[:2]
    max_bytes = max(len(j) for j in jpegs)
    n = len(jpegs)
    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        int(1_000_000 / fps),  # dwMicroSecPerFrame
        max_bytes * fps,       # dwMaxBytesPerSec
        0,                     # dwPaddingGranularity
        AVIF_HASINDEX,         # dwFlags
        n,                     # dwTotalFrames
        0,                     # dwInitialFrames
        1,                     # dwStreams
        max_bytes,             # dwSuggestedBufferSize
        w, h,
        0, 0, 0, 0,            # dwReserved
    )
    strh = struct.pack(
        "<4s4sIHHIIIIIIiI4H",
        b"vids", b"MJPG",
        0,                     # dwFlags
        0, 0,                  # wPriority, wLanguage
        0,                     # dwInitialFrames
        1,                     # dwScale
        fps,                   # dwRate
        0,                     # dwStart
        n,                     # dwLength (frames)
        max_bytes,             # dwSuggestedBufferSize
        -1,                    # dwQuality
        0,                     # dwSampleSize
        0, 0, w, h,            # rcFrame
    )
    strf = struct.pack(
        "<IiiHH4sIiiII",
        40,                    # biSize
        w, h,
        1,                     # biPlanes
        24,                    # biBitCount
        b"MJPG",               # biCompression
        w * h * 3,             # biSizeImage
        0, 0, 0, 0,
    )
    strl = _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf))
    hdrl = _list(b"hdrl", _chunk(b"avih", avih) + strl)
    movi_payload, index_entries = b"", []
    offset = 4  # convention: offsets relative to the 'movi' fourcc
    for j in jpegs:
        ch = _chunk(b"00dc", j)
        index_entries.append((offset, len(j)))
        movi_payload += ch
        offset += len(ch)
    idx1 = b"".join(b"00dc" + struct.pack("<III", AVIIF_KEYFRAME, off, size)
                    for off, size in index_entries)
    riff_payload = b"AVI " + hdrl + _list(b"movi", movi_payload) + _chunk(b"idx1", idx1)
    with open(out_path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)
    return out_path


def read_mjpeg_avi(path: str) -> List[bytes]:
    """The JPEG bytes of every '00dc' chunk, in order (the port has no JPEG
    decoder; the JAX package's reader decodes them with PIL)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"AVI ":
        raise ValueError(f"{path}: not an AVI")
    jpegs = []
    i = data.index(b"movi") + 4
    while i + 8 <= len(data):
        fourcc = data[i:i + 4]
        (size,) = struct.unpack("<I", data[i + 4:i + 8])
        if fourcc == b"00dc":
            jpegs.append(data[i + 8:i + 8 + size])
        elif fourcc in (b"idx1", b"LIST"):
            break
        i += 8 + size + (size % 2)
    return jpegs


def write_video(frames, out_path: str, fps: int = 25) -> str:
    """Write frames as MJPEG-AVI; an ``.mp4`` path becomes ``.avi`` (the
    port has no mp4 encoder) and says so.  Returns the path written."""
    if out_path.endswith(".mp4"):
        out_path = out_path[: -len(".mp4")] + ".avi"
        print(f"no mp4 encoder: writing MJPEG-AVI {out_path}", flush=True)
    return write_mjpeg_avi(frames, out_path, fps=fps)
