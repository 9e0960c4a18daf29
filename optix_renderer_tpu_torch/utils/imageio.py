"""Image I/O with no image library: OpenEXR, PNG and Radiance HDR, and the sRGB transfers.

Counterpart of `optix_renderer_tpu/utils/imageio.py` (the reference
`Bitmap`, bitmap.cpp, and HDRLoader.h): EXR for HDR render output, PNG for
LDR, and the texture / envmap readers. The EXR codec and the RGBE reader are
the JAX package's pure-numpy ones. PNG is read and written with `zlib` +
`struct` instead of PIL, so the package needs no image library; other
formats (JPG, BMP, ...) go to PIL, imported when such a file is read.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_EXR_MAGIC = 20000630


def _attr(name: str, type_: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_.encode() + b"\x00"
        + struct.pack("<i", len(data)) + data
    )


def _chlist(names) -> bytes:
    out = b""
    for n in sorted(names):
        # name, pixel type (2=FLOAT), pLinear, reserved[3], xSampling, ySampling
        out += n.encode() + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    return out + b"\x00"


def write_exr(path: str | Path, image: np.ndarray) -> None:
    """Write [h,w,3] (RGB) or [h,w,4] (RGBA) float32 as uncompressed EXR."""
    img = np.asarray(image, np.float32)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected [h,w,3|4], got {img.shape}")
    h, w, c = img.shape
    names = ["R", "G", "B"] + (["A"] if c == 4 else [])
    chan = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
    if c == 4:
        chan["A"] = img[..., 3]

    header = b""
    header += _attr("channels", "chlist", _chlist(names))
    header += _attr("compression", "compression", b"\x00")  # none
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\x00")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    preamble = struct.pack("<ii", _EXR_MAGIC, 2) + header
    offset0 = len(preamble) + 8 * h
    line_bytes = 8 + len(names) * w * 4
    offsets = struct.pack("<%dQ" % h, *[offset0 + y * line_bytes for y in range(h)])

    body = bytearray()
    for y in range(h):
        body += struct.pack("<ii", y, len(names) * w * 4)
        for n in sorted(names):
            body += chan[n][y].astype("<f4").tobytes()

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(offsets)
        f.write(body)


def _read_exr_header(buf: bytes):
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    attrs = {}
    while buf[pos] != 0:
        end = buf.index(b"\x00", pos)
        name = buf[pos:end].decode()
        pos = end + 1
        end = buf.index(b"\x00", pos)
        type_ = buf[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (type_, buf[pos : pos + size])
        pos += size
    return attrs, pos + 1


def read_exr(path: str | Path) -> np.ndarray:
    """Read an EXR written by `write_exr` (or any uncompressed/zip FLOAT
    scanline EXR with R,G,B[,A] channels). Returns [h,w,3|4] float32."""
    buf = Path(path).read_bytes()
    attrs, pos = _read_exr_header(buf)
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    compression = attrs["compression"][1][0]

    # parse channel list
    chdata = attrs["channels"][1]
    names = []
    cpos = 0
    while chdata[cpos] != 0:
        end = chdata.index(b"\x00", cpos)
        names.append(chdata[cpos:end].decode())
        cpos = end + 1 + 16
    names_sorted = sorted(names)

    n_lines_per_block = {0: 1, 1: 1, 2: 1, 3: 16}.get(compression)
    if n_lines_per_block is None:
        raise ValueError(f"unsupported EXR compression {compression}")
    n_blocks = (h + n_lines_per_block - 1) // n_lines_per_block
    offsets = struct.unpack_from("<%dQ" % n_blocks, buf, pos)

    out = {n: np.zeros((h, w), np.float32) for n in names_sorted}
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + size]
        nlines = min(n_lines_per_block, h - (y - y0))
        raw_size = nlines * len(names_sorted) * w * 4
        if compression in (2, 3) and size != raw_size:
            data = zlib.decompress(data)
            d = np.frombuffer(data, np.uint8).copy()
            # EXR zip predictor: delta decode then de-interleave
            d[1:] = (np.cumsum(d.astype(np.int64)) % 256)[1:].astype(np.uint8)
            half = (len(d) + 1) // 2
            interleaved = np.empty(len(d), np.uint8)
            interleaved[0::2] = d[:half]
            interleaved[1::2] = d[half : half + len(d) - half]
            data = interleaved.tobytes()
        arr = np.frombuffer(data, "<f4").reshape(nlines, len(names_sorted), w)
        for li in range(nlines):
            for ci, n in enumerate(names_sorted):
                out[n][y - y0 + li] = arr[li, ci]

    chans = [out[n] for n in ["R", "G", "B"] if n in out]
    if "A" in out:
        chans.append(out["A"])
    return np.stack(chans, axis=-1)


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    return np.where(img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    return np.where(
        img <= 0.0031308,
        12.92 * img,
        1.055 * np.maximum(img, 1e-12) ** (1.0 / 2.4) - 0.055,
    )


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(image: np.ndarray, tonemap: bool = True) -> bytes:
    """[h,w,3] linear float32 → 8-bit RGB PNG bytes (sRGB, like hdrToLdr.cpp:22-40)."""
    img = np.asarray(image, np.float32)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [h,w,3], got {img.shape}")
    if tonemap:
        img = linear_to_srgb(img)
    img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w, _ = img.shape
    # one filter byte (0 = none) before each scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit truecolour
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def write_png(path: str | Path, image: np.ndarray, tonemap: bool = True) -> None:
    """Write [h,w,3] linear float32 → PNG."""
    Path(path).write_bytes(encode_png(image, tonemap))


# channels per PNG colour type: gray, RGB, gray + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters 0-4 (PNG spec. 9.2) → [h, stride] uint8."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, cur = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            line = cur.copy()
        elif kind == 1:  # Sub: a running sum per byte lane of the pixel
            line = (np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.int64) % 256
                    ).astype(np.uint8).reshape(-1)
        elif kind == 2:  # Up
            line = cur + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one before
            c, p, line = cur.tolist(), prev.tolist(), [0] * stride
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + p[i]) >> 1
                else:
                    pred = _paeth(a, p[i], p[i - bpp] if i >= bpp else 0)
                line[i] = (c[i] + pred) & 0xFF
            line = np.asarray(line, np.uint8)
        else:
            raise ValueError(f"PNG scanline {y} has unknown filter type {kind}")
        out[y] = prev = line
    return out


def _png_palette_indices(data: bytes, h: int, w: int, depth: int) -> np.ndarray:
    """Unfiltered palette scanlines → [h,w] indices; below 8 bits several
    indices share a byte, the leftmost pixel in its high bits."""
    stride = (w * depth + 7) // 8
    rows = _unfilter(data, h, stride, 1)
    if depth == 8:
        return rows
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)  # high bits first
    idx = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return idx.reshape(h, stride * per)[:, :w]


def read_png(path: str | Path) -> np.ndarray:
    """Decode a non-interlaced 8-bit PNG (gray, gray + alpha, RGB or RGBA)
    or a palette PNG of 1-, 2-, 4- or 8-bit indices → [h,w,3] float32 in
    [0,1]; alpha (and a palette's tRNS) is dropped, as PIL's
    `convert("RGB")` drops it. 16-bit, sub-byte gray and interlaced files
    raise (the JAX package reads a 16-bit PNG through PIL, which clips it to
    nearly white)."""
    buf = Path(path).read_bytes()
    if buf[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, ihdr, plte = 8, [], None, None
    while pos < len(buf):
        (n,) = struct.unpack_from(">I", buf, pos)
        kind, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"PLTE":
            plte = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    data = zlib.decompress(b"".join(idat))
    if ctype == 3:
        if depth not in (1, 2, 4, 8):
            raise ValueError(f"{path}: palette PNG with {depth}-bit indices")
        if plte is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        idx = _png_palette_indices(data, h, w, depth)
        if int(idx.max(initial=0)) >= plte.shape[0]:
            raise ValueError(f"{path}: palette index past the {plte.shape[0]} PLTE entries")
        return plte[idx].astype(np.float32) / 255.0
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG is not supported (8-bit only)")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is not supported (gray, gray + "
                         "alpha, RGB, RGBA, palette)")
    ch = _PNG_CHANNELS[ctype]
    px = _unfilter(data, h, w * ch, ch).reshape(h, w, ch)
    rgb = np.repeat(px[..., :1], 3, axis=-1) if ch <= 2 else px[..., :3]
    return rgb.astype(np.float32) / 255.0


def read_hdr(path: str | Path) -> np.ndarray:
    """Read a Radiance RGBE `.hdr` file → [h,w,3] float32 linear HDR.

    Counterpart of the reference's HDRLoader (HDRLoader.h:28-33 decode:
    v = mantissa/256 · 2^(E−128)); new-style RLE scanlines and flat RGBE rows.
    """
    buf = Path(path).read_bytes()
    # header: text lines until a blank line, then the resolution line
    pos = 0
    if not (buf.startswith(b"#?RADIANCE") or buf.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        end = buf.index(b"\n", pos)
        line = buf[pos:end]
        pos = end + 1
        if line == b"":
            break
    end = buf.index(b"\n", pos)
    res = buf[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported HDR orientation {res}")
    h, w = int(res[1]), int(res[3])

    data = np.frombuffer(buf, np.uint8, offset=pos)
    rgbe = np.zeros((h, w, 4), np.uint8)
    dpos = 0
    for y in range(h):
        # new-style RLE scanline: 0x02 0x02 hi lo, per-channel RLE runs
        if w >= 8 and w < 32768 and data[dpos] == 2 and data[dpos + 1] == 2 and (
            (int(data[dpos + 2]) << 8) | int(data[dpos + 3])
        ) == w:
            dpos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(data[dpos])
                    if count > 128:  # run of a repeated byte
                        rgbe[y, x : x + count - 128, c] = data[dpos + 1]
                        x += count - 128
                        dpos += 2
                    else:  # literal bytes
                        rgbe[y, x : x + count, c] = data[dpos + 1 : dpos + 1 + count]
                        x += count
                        dpos += 1 + count
        else:  # flat RGBE row (old format; old-style 1,1,1 RLE is not read)
            rgbe[y] = data[dpos : dpos + w * 4].reshape(w, 4)
            dpos += w * 4
    mant = rgbe[..., :3].astype(np.float32) / 256.0
    expo = rgbe[..., 3].astype(np.int32) - 128
    out = mant * np.exp2(expo.astype(np.float32))[..., None]
    out[rgbe[..., 3] == 0] = 0.0
    return out


def read_image(path: str | Path) -> np.ndarray:
    """Read PNG, `.hdr` (RGBE) or EXR, or any other format PIL opens (JPG,
    BMP, ...) → [h,w,3] float32; the LDR formats land in [0,1], the HDR
    formats keep linear radiance. PIL is imported only for those other
    formats, and its absence raises ImportError naming the file."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".exr":
        return read_exr(path)[..., :3]
    if suffix == ".hdr":
        return read_hdr(path)
    if suffix == ".png":
        return read_png(path)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: reading '{suffix}' images needs PIL (Pillow), which is not "
                          "installed; PNG, HDR and EXR need no image library") from e
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.float32) / 255.0
