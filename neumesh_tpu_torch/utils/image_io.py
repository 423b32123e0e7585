"""PNG files and the two image resizes of the DTU loader, in the standard
library and numpy (the card machine has no imageio, Pillow or OpenCV).

read_png / write_png: non-interlaced PNG, 8 or 16 bits per sample, gray
(color type 0), gray + alpha (4), RGB (2) and RGBA (6); the decoder
undoes all five row filters, the encoder writes filter 0. Arrays come
back as imageio.v2.imread gives them: (H, W) for gray, (H, W, C)
otherwise, uint8 or uint16.

resize_area / resize_nearest: cv2.resize with INTER_AREA (downscaling)
and INTER_NEAREST at an explicit destination size.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    return decode_png(data, path)


def decode_png(data: bytes, where: str = "<png>") -> np.ndarray:
    if data[:8] != _SIG:
        raise ValueError(f"{where}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{where}: truncated chunk header")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{where}: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{where}: CRC mismatch in {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind[0] & 0x20 == 0:           # critical chunk not understood
            raise ValueError(f"{where}: unsupported PNG chunk {kind!r} "
                             "(palette images are not supported)")
    if ihdr is None or not idat:
        raise ValueError(f"{where}: missing IHDR or IDAT")
    W, H, depth, ctype, comp, filt, interlace = ihdr
    if ctype not in _CHANNELS or depth not in (8, 16) or comp or filt \
            or interlace:
        raise ValueError(f"{where}: unsupported PNG (color type {ctype}, "
                         f"bit depth {depth}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = W * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"{where}: image data is {raw.size} bytes, want "
                         f"{H * (stride + 1)}")
    rows = raw.reshape(H, stride + 1)
    ftype = rows[:, 0].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{where}: bad row filter {ftype.max()}")
    px = _unfilter(rows[:, 1:].astype(np.int32), ftype, bpp, W)
    if depth == 16:
        px = px.reshape(H, W * ch, 2)
        img = (px[..., 0] << 8 | px[..., 1]).astype(np.uint16)
    else:
        img = px.astype(np.uint8)
    img = img.reshape(H, W, ch)
    return img[..., 0] if ch == 1 else img


def _unfilter(filt, ftype, bpp, W):
    """Undo the per-row filters. A pixel depends on its left neighbour and
    on the row above, so pixels are reconstructed one anti-diagonal
    (row + column = t) at a time, every row of a diagonal at once."""
    H = filt.shape[0]
    rec = np.zeros((H + 1, (W + 1) * bpp), np.int32)  # zero row / column pad
    chan = np.arange(bpp)
    for t in range(H + W - 1):
        r = np.arange(max(0, t - W + 1), min(H, t + 1))
        x = ((t - r)[:, None] * bpp + chan).reshape(-1)      # byte column
        rr = np.repeat(r, bpp)
        a = rec[rr + 1, x]                                   # left
        b = rec[rr, x + bpp]                                 # up
        c = rec[rr, x]                                       # up-left
        f = ftype[rr]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[rr + 1, x + bpp] = (filt[rr, x] + pred) & 0xFF
    return rec[1:, bpp:]


def encode_png(img: np.ndarray) -> bytes:
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"PNG: dtype {img.dtype}, want uint8 or uint16")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"PNG: shape {img.shape}")
    H, W, ch = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 16 if img.dtype == np.uint16 else 8
    px = img.astype(">u2" if depth == 16 else np.uint8).tobytes()
    stride = W * ch * depth // 8
    raw = b"".join(b"\x00" + px[i * stride:(i + 1) * stride]
                   for i in range(H))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype,
                                              0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# ---------------------------------------------------------------------------
# resizes
# ---------------------------------------------------------------------------

def _area_weights(n_src: int, n_dst: int) -> np.ndarray:
    """(n_dst, n_src) INTER_AREA weights: each destination cell averages
    the source cells it covers, partial cells by their covered fraction
    (cv2's computeResizeAreaTab, the 1e-3 edge threshold included)."""
    scale = 1.0 / (n_dst / n_src)          # as cv2 computes it
    w = np.zeros((n_dst, n_src))
    for dx in range(n_dst):
        fs1 = dx * scale
        fs2 = fs1 + scale
        cell = min(scale, n_src - fs1)
        s1 = int(np.ceil(fs1))
        s2 = min(int(np.floor(fs2)), n_src - 1)
        s1 = min(s1, s2)
        if s1 - fs1 > 1e-3:
            w[dx, s1 - 1] = (s1 - fs1) / cell
        w[dx, s1:s2] = 1.0 / cell
        if fs2 - s2 > 1e-3:
            w[dx, s2] = min(min(fs2 - s2, 1.0), cell) / cell
    return w


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA) of a
    float image, downscaling only (an integer factor is the block mean)."""
    h, w = img.shape[:2]
    if width > w or height > h or width < 1 or height < 1:
        raise ValueError(f"resize_area: {w}x{h} -> {width}x{height} is not a "
                         "downscale")
    if (width, height) == (w, h):
        return img.copy()
    wy, wx = _area_weights(h, height), _area_weights(w, width)
    x = np.asarray(img, np.float64)
    out = np.einsum("yh,hw...->yw...", wy, x)
    out = np.einsum("xw,yw...->yx...", wx, out)
    return out.astype(img.dtype)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST):
    source index floor(dst * src / dst_size), clipped to the last one."""
    h, w = img.shape[:2]
    fx, fy = 1.0 / (width / w), 1.0 / (height / h)     # as cv2 computes it
    sx = np.minimum(np.floor(np.arange(width) * fx).astype(np.int64), w - 1)
    sy = np.minimum(np.floor(np.arange(height) * fy).astype(np.int64), h - 1)
    return img[sy][:, sx]
