"""Image IO: OpenEXR (uncompressed scanline) write/read, 8-bit PNG write
and read, PFM, Radiance HDR and NPY.

Counterpart of luisarender_tpu/utils/imageio.py. The reference reads LDR
textures through Pillow; the port decodes PNG itself (zlib and numpy:
8-bit grey, RGB, palette, grey-alpha and RGBA, every scanline filter) into
the same RGBA bytes Pillow's `convert("RGBA")` gives, and then decodes
sRGB exactly as the reference does. 16-bit, sub-byte and interlaced PNGs
raise NotImplementedError.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


# ---------------------------------------------------------------------------
# EXR
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PIXEL_HALF = 1
_PIXEL_FLOAT = 2


def _exr_attr(name: str, type_name: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_name.encode() + b"\x00"
        + struct.pack("<i", len(data)) + data
    )


def save_exr(path, image: np.ndarray, half: bool = False):
    """Write an RGB(A) float image as uncompressed scanline EXR."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 2:
        image = image[..., None]
    h, w, c = image.shape
    names = ["R", "G", "B", "A"][:c] if c <= 4 else [f"C{i}" for i in range(c)]
    # channels are stored alphabetically in EXR
    chan_order = sorted(range(c), key=lambda i: names[i])
    pix_type = _PIXEL_HALF if half else _PIXEL_FLOAT
    dtype = np.float16 if half else np.float32

    chlist = b""
    for i in chan_order:
        chlist += (
            names[i].encode() + b"\x00"
            + struct.pack("<i", pix_type)
            + struct.pack("<i", 0)  # pLinear + reserved
            + struct.pack("<ii", 1, 1)  # x/y sampling
        )
    chlist += b"\x00"

    header = b""
    header += _exr_attr("channels", "chlist", chlist)
    header += _exr_attr("compression", "compression", b"\x00")  # none
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _exr_attr("dataWindow", "box2i", box)
    header += _exr_attr("displayWindow", "box2i", box)
    header += _exr_attr("lineOrder", "lineOrder", b"\x00")
    header += _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _exr_attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    bytes_per_px = 2 if half else 4
    line_size = w * c * bytes_per_px
    offset_table_size = 8 * h
    data_start = 8 + len(header) + offset_table_size

    with open(path, "wb") as f:
        f.write(struct.pack("<I", _EXR_MAGIC))
        f.write(struct.pack("<I", 2))  # version 2, scanline
        f.write(header)
        line_bytes = 8 + line_size  # y + pixel data per scanline chunk
        for y in range(h):
            f.write(struct.pack("<Q", data_start + y * line_bytes))
        for y in range(h):
            f.write(struct.pack("<ii", y, line_size))
            row = image[y]
            for i in chan_order:
                f.write(row[:, i].astype(dtype).tobytes())


def load_exr(path):
    """Minimal reader for the files save_exr writes (uncompressed scanline)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<II", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    channels = []
    data_window = None
    compression = 0
    while True:
        if data[pos] == 0:
            pos += 1
            break
        end = data.index(b"\x00", pos)
        name = data[pos:end].decode()
        pos = end + 1
        end = data.index(b"\x00", pos)
        type_name = data[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        payload = data[pos : pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                ce = payload.index(b"\x00", cp)
                cname = payload[cp:ce].decode()
                cp = ce + 1
                (ptype,) = struct.unpack_from("<i", payload, cp)
                cp += 16
                channels.append((cname, ptype))
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)
        elif name == "compression":
            compression = payload[0]
    if compression != 0:
        raise ValueError("load_exr supports only uncompressed files")
    x0, y0, x1, y1 = data_window
    w, h = x1 - x0 + 1, y1 - y0 + 1
    c = len(channels)
    pos += 8 * h  # offset table
    out = np.zeros((h, w, c), np.float32)
    for y in range(h):
        _, line_size = struct.unpack_from("<ii", data, pos)
        pos += 8
        off = 0
        for i, (cname, ptype) in enumerate(channels):
            dt = np.float16 if ptype == _PIXEL_HALF else np.float32
            n = w * np.dtype(dt).itemsize
            out[y, :, i] = np.frombuffer(data[pos + off : pos + off + n], dt)
            off += n
        pos += line_size
    # reorder alphabetical channel order back to RGBA when applicable
    names = [cn for cn, _ in channels]
    want = [n for n in ["R", "G", "B", "A"] if n in names]
    if len(want) == c:
        out = out[..., [names.index(n) for n in want]]
    return out


# ---------------------------------------------------------------------------
# PNG (write; 8-bit sRGB)
# ---------------------------------------------------------------------------


def png_bytes(image: np.ndarray) -> bytes:
    """Encode (H, W, 1|3|4) [0,1] to an in-memory 8-bit PNG."""
    img = np.clip(np.asarray(image), 0.0, 1.0)
    img8 = (img * 255.0 + 0.5).astype(np.uint8)
    h, w, c = img8.shape
    color_type = {1: 0, 3: 2, 4: 6}[c]
    raw = b"".join(b"\x00" + img8[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        body = tag + payload
        return struct.pack(">I", len(payload)) + body + struct.pack(
            ">I", zlib.crc32(body) & 0xFFFFFFFF
        )

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def save_png(path, image: np.ndarray):
    """image: (H, W, 3|4) in [0, 1] linear-encoded already (caller applies
    tonemap/sRGB encode); writes 8-bit PNG."""
    with open(path, "wb") as f:
        f.write(png_bytes(image))


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# samples a pixel of each colour type: grey, RGB, palette, grey-alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(data, h, stride, bpp):
    """Undo the PNG scanline filters (None, Sub, Up, Average, Paeth) of h
    rows of `stride` bytes, each led by its filter byte, bpp the bytes a
    pixel (at least 1) -> (h, stride) uint8. Sub and Up run vectorized;
    Average and Paeth, whose bytes depend on the decoded byte before them,
    byte by byte."""
    rows = np.frombuffer(data, np.uint8)[: h * (stride + 1)]
    if rows.shape[0] < h * (stride + 1):
        raise ValueError("PNG: image data ends early")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:
            cur = np.cumsum(line.reshape(stride // bpp, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):
            raw = line.tolist()
            up = prev.tolist()
            cur_l = [0] * stride
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_l[x] = (raw[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int64)
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def _png_samples(data, h, w, ch, depth):
    """The filtered rows of an h x w image (data: its rows, each led by a
    filter byte) -> (h, w, ch) int64 samples at `depth` bits."""
    stride = (w * ch * depth + 7) // 8
    rows = _unfilter(data, h, stride, max(1, ch * depth // 8))
    if depth == 16:
        v = rows.reshape(h, w * ch, 2).astype(np.int64)
        return ((v[..., 0] << 8) | v[..., 1]).reshape(h, w, ch)
    if depth == 8:
        return rows.astype(np.int64).reshape(h, w, ch)
    per = 8 // depth
    shifts = np.asarray([8 - depth * (i + 1) for i in range(per)], np.int64)
    v = (rows.astype(np.int64)[..., None] >> shifts) & ((1 << depth) - 1)
    return v.reshape(h, stride * per)[:, : w * ch].reshape(h, w, ch)


def _png_pixels(raw, h, w, ch, depth, interlace):
    """(h, w, ch) samples of the decompressed image data, Adam7's seven
    passes put in place where the PNG is interlaced."""
    if not interlace:
        return _png_samples(raw, h, w, ch, depth)
    out = np.zeros((h, w, ch), np.int64)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        size = ph * ((pw * ch * depth + 7) // 8 + 1)
        out[y0::dy, x0::dx] = _png_samples(raw[pos : pos + size], ph, pw, ch, depth)
        pos += size
    return out


def png_rgba8(path) -> np.ndarray:
    """A PNG file of any bit depth, colour type and interlace -> (H, W, 4)
    uint8 RGBA, as Pillow 12's `Image.open(path).convert("RGBA")` gives it:

    - grey of 1, 2 or 4 bits scaled to 8 (x255, x85, x17), replicated into
      RGB; 16-bit grey clamped to 255 (Pillow opens it as I;16);
    - 16-bit RGB, RGBA and grey-alpha reduced to their high bytes;
    - a palette's colours and its tRNS alphas (indices of 1-8 bits);
    - a tRNS colour key of grey or RGB made transparent where the 8-bit
      pixel equals it: a 1-bit key scaled by 255, a 16-bit key's low byte;
      alpha 255 elsewhere."""
    return png_rgba8_bytes(Path(path).read_bytes(), path)


def png_rgba8_bytes(data: bytes, path="<bytes>") -> np.ndarray:
    """png_rgba8 of a PNG file's bytes; `path` names it in errors."""
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    ihdr = None
    palette = trns = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = payload
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if ctype not in _PNG_CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits")
    ch = _PNG_CHANNELS[ctype]
    px = _png_pixels(zlib.decompress(b"".join(idat)), h, w, ch, depth, interlace)
    out = np.full((h, w, 4), 255, np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        alpha = np.full(palette.shape[0], 255, np.uint8)
        if trns is not None:
            t = np.frombuffer(trns, np.uint8)[: palette.shape[0]]
            alpha[: t.shape[0]] = t
        idx = np.minimum(px[..., 0], palette.shape[0] - 1)
        out[..., :3] = palette[idx]
        out[..., 3] = alpha[idx]
        return out
    if depth == 16:
        # grey opens as I;16 and clamps; the other types keep the high byte
        px8 = np.minimum(px, 255) if ctype == 0 else px >> 8
    elif depth < 8:
        px8 = px * (255 // ((1 << depth) - 1))
    else:
        px8 = px
    if ctype in (0, 4):
        out[..., :3] = px8[..., :1]
        if ctype == 4:
            out[..., 3] = px8[..., 1]
        elif trns is not None:
            key = struct.unpack(">H", trns[:2])[0]
            key = key * 255 if depth == 1 else key & 0xFF if depth == 16 else key
            out[..., 3] = np.where(px8[..., 0] == key, 0, 255)
        return out
    out[..., :ch] = px8
    if ctype == 2 and trns is not None:
        key = np.asarray(struct.unpack(">HHH", trns[:6]))
        key = key & 0xFF if depth == 16 else key
        out[..., 3] = np.where(np.all(px8 == key, axis=-1), 0, 255)
    return out


# ---------------------------------------------------------------------------
# PFM, Radiance HDR
# ---------------------------------------------------------------------------


def save_pfm(path, image: np.ndarray):
    image = np.asarray(image, np.float32)
    h, w = image.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if image.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little endian
        f.write(np.flipud(image).tobytes())


def load_pfm(path):
    with open(path, "rb") as f:
        header = f.readline().strip()
        ch = 3 if header == b"PF" else 1
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4").reshape(h, w, ch)
        return np.flipud(data).astype(np.float32)


def load_hdr(path):
    """Radiance RGBE (.hdr) reader (run-length and flat scanlines)."""
    with open(path, "rb") as f:
        if not f.readline().startswith(b"#?"):
            raise ValueError("not a Radiance HDR file")
        while True:
            line = f.readline().strip()
            if not line:
                break
        dims = f.readline().split()
        h, w = int(dims[1]), int(dims[3])
        data = f.read()
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if (pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            pos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = data[pos]
                    pos += 1
                    if count > 128:
                        rgbe[y, x : x + count - 128, c] = data[pos]
                        pos += 1
                        x += count - 128
                    else:
                        rgbe[y, x : x + count, c] = np.frombuffer(data[pos : pos + count], np.uint8)
                        pos += count
                        x += count
        else:
            rgbe[y] = np.frombuffer(data[pos : pos + 4 * w], np.uint8).reshape(w, 4)
            pos += 4 * w
    exp = rgbe[..., 3].astype(np.int32) - 136
    scale = np.ldexp(1.0, exp).astype(np.float32)
    rgb = rgbe[..., :3].astype(np.float32) * scale[..., None]
    rgb[rgbe[..., 3] == 0] = 0.0
    return rgb


# ---------------------------------------------------------------------------
# Generic entry points
# ---------------------------------------------------------------------------


def srgb_encode(linear: np.ndarray) -> np.ndarray:
    """Linear -> sRGB gamma (EOTF^-1)."""
    linear = np.maximum(linear, 0.0)
    return np.where(
        linear <= 0.0031308,
        12.92 * linear,
        1.055 * np.power(np.maximum(linear, 1e-10), 1.0 / 2.4) - 0.055,
    ).astype(np.float32)


def save_image(path, image: np.ndarray):
    """Dispatch on extension: linear EXR / NPY, sRGB-encoded PNG."""
    path = Path(path)
    image = np.asarray(image, np.float32)
    suffix = path.suffix.lower()
    if suffix == ".exr":
        save_exr(path, image)
    elif suffix == ".png":
        save_png(path, srgb_encode(image))
    elif suffix == ".npy":
        np.save(path, image)
    elif suffix == ".pfm":
        save_pfm(path, image)
    else:
        raise ValueError(f"unsupported image format: {suffix}")


def load_image(path):
    """An image as float32 (H, W, C); LDR (PNG) is sRGB-decoded to linear
    RGBA in the reference's float32 arithmetic."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".exr":
        return load_exr(path)
    if suffix == ".npy":
        return np.load(path).astype(np.float32)
    if suffix == ".pfm":
        return load_pfm(path)
    if suffix == ".hdr":
        return load_hdr(path)
    img = png_rgba8(path).astype(np.float32) / 255.0
    rgb = img[..., :3]
    # the sRGB EOTF
    lin = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    return np.concatenate([lin, img[..., 3:4]], axis=-1).astype(np.float32)
