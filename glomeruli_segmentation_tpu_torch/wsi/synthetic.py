"""Synthetic pyramidal slide writer (test fixtures and benchmarks).

The reference's sample ``.ndpi`` is stripped from the mirror
(``example/.MISSING_LARGE_BLOBS``), so the framework ships its own
generator: writes a tiled, JPEG- or raw-compressed classic-TIFF pyramid
with known mpp / objective power that both the pure-python and C++ readers
(and any TIFF tool) can open.  Used to test the WSI layer without real
slides and to synthesize PAS-like benchmark slides of arbitrary size.

The port's own copy of ``glomeruli_segmentation_tpu/wsi/synthetic.py`` (the
port imports nothing of the JAX package); a test holds both writers to the
same bytes.  JPEG encoding imports cv2 at first use.
"""
from __future__ import annotations

import math
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

_TYPE_SHORT, _TYPE_LONG, _TYPE_RATIONAL, _TYPE_FLOAT = 3, 4, 5, 11


class _IfdWriter:
    def __init__(self):
        self.entries = []  # (tag, type, count, payload_bytes, inline)

    def add(self, tag: int, typ: int, values: Sequence):
        if typ == _TYPE_SHORT:
            payload = struct.pack("<" + "H" * len(values), *values)
        elif typ == _TYPE_LONG:
            payload = struct.pack("<" + "I" * len(values), *values)
        elif typ == _TYPE_RATIONAL:
            flat = [v for pair in values for v in pair]
            payload = struct.pack("<" + "I" * len(flat), *flat)
        elif typ == _TYPE_FLOAT:
            payload = struct.pack("<" + "f" * len(values), *values)
        else:
            raise ValueError(typ)
        self.entries.append((tag, typ, len(values), payload))


def _downsample2(img: np.ndarray) -> np.ndarray:
    h, w = img.shape[:2]
    h2, w2 = h // 2 * 2, w // 2 * 2
    img = img[:h2, :w2].astype(np.uint16)
    out = (img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2]
           + img[1::2, 1::2] + 2) // 4
    return out.astype(np.uint8)


def pas_like_image(height: int, width: int, seed: int = 0,
                   n_glomeruli: int = 8,
                   background=(230, 205, 215),
                   blob_color=(170, 110, 150),
                   inner_color=(140, 80, 120),
                   radius_frac=(1 / 20, 1 / 10),
                   centers: Optional[Sequence[Tuple[int, int, int]]] = None,
                   ) -> np.ndarray:
    """Generate an RGB image resembling a PAS-stained section with dark
    round 'glomeruli' blobs on a pinkish background.

    ``background``/``blob_color``/``inner_color``/``radius_frac`` vary the
    stain tone, contrast and glomerulus size — used to build slide
    *populations* for detector accuracy tests (vs the reference's per-slide
    recall print, make_seg_data.py:107-111).  Passing explicit ``centers``
    ((cx, cy, r) triples) places the blobs deterministically — for
    clustered-glomeruli and window-straddling test cases."""
    rng = np.random.RandomState(seed)
    img = np.full((height, width, 3), background, np.uint8)
    noise = rng.randint(-12, 12, size=img.shape).astype(np.int16)
    img = np.clip(img.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    r_lo = max(8, int(min(height, width) * radius_frac[0]))
    r_hi = max(r_lo + 1, int(min(height, width) * radius_frac[1]))
    if centers is None:
        centers = []
        for _ in range(n_glomeruli):
            cy = rng.randint(height // 8, height * 7 // 8)
            cx = rng.randint(width // 8, width * 7 // 8)
            r = rng.randint(r_lo, r_hi)
            centers.append((cx, cy, r))
    else:
        centers = [tuple(c) for c in centers]
    for cx, cy, r in centers:
        # each disc within its bounding box: the same pixels as over the
        # whole image, at a cost that does not grow with the image
        y0, y1 = max(cy - r, 0), min(cy + r + 1, height)
        x0, x1 = max(cx - r, 0), min(cx + r + 1, width)
        if y0 >= y1 or x0 >= x1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        dist2 = (yy - cy) ** 2 + (xx - cx) ** 2
        box = img[y0:y1, x0:x1]
        box[dist2 < r ** 2] = blob_color
        box[dist2 < (r // 2) ** 2] = inner_color
    return img, centers


def write_pyramidal_tiff(
    path: str,
    base_image: np.ndarray,
    mpp: float = 0.228,
    objective_power: float = 40.0,
    tile_size: int = 256,
    levels: Optional[int] = None,
    compression: str = "jpeg",
    jpeg_quality: int = 90,
) -> None:
    """Write a little-endian classic-TIFF pyramid.

    Level k is the base image downsampled by 2**k.  ``mpp`` is encoded via
    X/YResolution with ResolutionUnit=cm so readers recover it exactly when
    ``10000/mpp`` is rational; objective power goes in the NDPI SourceLens
    tag (65421).
    """
    h, w = base_image.shape[:2]
    if levels is None:
        levels = max(1, int(math.log2(max(h, w) / tile_size)) + 1)
    images = [base_image]
    for _ in range(levels - 1):
        images.append(_downsample2(images[-1]))

    # mpp -> rational pixels-per-cm, with num constrained to u32
    den = 1_000_000
    num = int(round(10000.0 / mpp * den))
    while num >= 2**32:
        den //= 10
        num = int(round(10000.0 / mpp * den))

    chunks: List[bytes] = []  # file payload chunks after header
    header = struct.pack("<2sHI", b"II", 42, 0)  # IFD offset patched later
    pos = len(header)

    def alloc(data: bytes) -> int:
        nonlocal pos
        if pos % 2:
            chunks.append(b"\0")
            pos += 1
        off = pos
        chunks.append(data)
        pos += len(data)
        return off

    ifd_offsets: List[int] = []
    ifd_blobs: List[bytes] = []
    for img in images:
        lh, lw = img.shape[:2]
        tiles_across = math.ceil(lw / tile_size)
        tiles_down = math.ceil(lh / tile_size)
        offsets: List[int] = []
        counts: List[int] = []
        for ty in range(tiles_down):
            for tx in range(tiles_across):
                tile = np.full((tile_size, tile_size, 3), 255, np.uint8)
                sub = img[ty * tile_size: (ty + 1) * tile_size,
                          tx * tile_size: (tx + 1) * tile_size]
                tile[: sub.shape[0], : sub.shape[1]] = sub
                if compression == "jpeg":
                    import cv2

                    ok, enc = cv2.imencode(
                        ".jpg", tile[:, :, ::-1],
                        [cv2.IMWRITE_JPEG_QUALITY, jpeg_quality])
                    assert ok
                    data = enc.tobytes()
                elif compression == "none":
                    data = tile.tobytes()
                else:
                    raise ValueError(compression)
                offsets.append(alloc(data))
                counts.append(len(data))

        b = _IfdWriter()
        b.add(256, _TYPE_LONG, [lw])
        b.add(257, _TYPE_LONG, [lh])
        b.add(258, _TYPE_SHORT, [8, 8, 8])
        b.add(259, _TYPE_SHORT, [7 if compression == "jpeg" else 1])
        b.add(262, _TYPE_SHORT, [6 if compression == "jpeg" else 2])
        b.add(277, _TYPE_SHORT, [3])
        b.add(282, _TYPE_RATIONAL, [(num, den)])
        b.add(283, _TYPE_RATIONAL, [(num, den)])
        b.add(296, _TYPE_SHORT, [3])  # centimetre
        b.add(322, _TYPE_LONG, [tile_size])
        b.add(323, _TYPE_LONG, [tile_size])
        b.add(324, _TYPE_LONG, offsets)
        b.add(325, _TYPE_LONG, counts)
        b.add(65421, _TYPE_FLOAT, [objective_power])

        entries = sorted(b.entries)
        ifd = struct.pack("<H", len(entries))
        deferred: List[Tuple[int, bytes]] = []
        body = b""
        for tag, typ, cnt, payload in entries:
            if len(payload) <= 4:
                value = payload.ljust(4, b"\0")
                body += struct.pack("<HHI", tag, typ, cnt) + value
            else:
                off = alloc(payload)
                body += struct.pack("<HHII", tag, typ, cnt, off)
        ifd += body + struct.pack("<I", 0)  # next-IFD patched later
        ifd_offsets.append(alloc(ifd))
        ifd_blobs.append(ifd)

    payload = b"".join(chunks)
    buf = bytearray(header + payload)
    # patch first-IFD offset and the next-IFD chain
    struct.pack_into("<I", buf, 4, ifd_offsets[0])
    for i in range(len(ifd_offsets) - 1):
        # next-IFD pointer sits in the last 4 bytes of the IFD blob
        end = ifd_offsets[i] + len(ifd_blobs[i]) - 4
        struct.pack_into("<I", buf, end, ifd_offsets[i + 1])
    with open(path, "wb") as f:
        f.write(bytes(buf))


# ---------------------------------------------------------------------------
# Real-NDPI layout emulation: one JPEG strip per level with restart markers
# ---------------------------------------------------------------------------

_MCU = 16  # 4:2:0 subsampling -> 16x16 MCUs (enforced at encode time)


def _jpeg_split(data: bytes):
    """Split an encoded JPEG into (headers through SOS, entropy bytes)."""
    assert data[:2] == b"\xff\xd8"
    pos = 2
    while True:
        assert data[pos] == 0xFF, data[pos]
        marker = data[pos + 1]
        if marker == 0xDA:  # SOS
            (seg_len,) = struct.unpack(">H", data[pos + 2: pos + 4])
            head_end = pos + 2 + seg_len
            entropy = data[head_end:]
            if entropy.endswith(b"\xff\xd9"):
                entropy = entropy[:-2]
            return data[:head_end], entropy
        (seg_len,) = struct.unpack(">H", data[pos + 2: pos + 4])
        pos += 2 + seg_len


def _encode_chunk(img: np.ndarray, quality: int) -> bytes:
    import cv2

    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    samp = getattr(cv2, "IMWRITE_JPEG_SAMPLING_FACTOR", None)
    if samp is not None:
        params += [samp, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    ok, enc = cv2.imencode(".jpg", img[:, :, ::-1], params)
    assert ok
    return enc.tobytes()


def encode_ndpi_strip(img: np.ndarray, rows_per_chunk: int = 1,
                      chunk_mcus_w: int = 0, quality: int = 90,
                      zero_sof_dims: bool = False,
                      return_mcu_starts: bool = False):
    """Encode ``img`` as ONE JPEG stream in the Hamamatsu NDPI layout: a
    restart marker every ``R`` MCUs so readers can decode chunks randomly.

    ``chunk_mcus_w == 0``: a chunk is ``rows_per_chunk`` full MCU rows
    (R = MCUs-per-row x rows_per_chunk — the layout of normal levels).
    ``chunk_mcus_w > 0``: a chunk is a horizontal segment of one MCU row
    (R = chunk_mcus_w; must divide the MCUs-per-row) — the layout NDPI
    uses for levels wider than JPEG's 65,500 px limit, whose SOF then
    records 0x0 dims (``zero_sof_dims``; true dims live in the TIFF tags).

    Chunks are encoded independently with identical tables/sampling and
    their entropy segments joined with renumbered RST markers — valid
    because DC predictors reset at restart boundaries.

    ``return_mcu_starts=True`` additionally returns each chunk's first
    entropy byte offset (strip-relative) — the payload of the NDPI
    McuStarts tag (65426) real scanners precompute so readers need not
    scan the multi-gigabyte entropy stream.
    """
    h, w = img.shape[:2]
    mpr = -(-w // _MCU)
    if chunk_mcus_w:
        assert mpr % chunk_mcus_w == 0, (mpr, chunk_mcus_w)
        restart = chunk_mcus_w
        chunk_imgs = []
        for y0 in range(0, h, _MCU):
            for x0 in range(0, w, chunk_mcus_w * _MCU):
                chunk_imgs.append(
                    img[y0: y0 + _MCU, x0: x0 + chunk_mcus_w * _MCU])
    else:
        restart = mpr * rows_per_chunk
        chunk_imgs = [img[y0: y0 + rows_per_chunk * _MCU]
                      for y0 in range(0, h, rows_per_chunk * _MCU)]

    encoded = [_jpeg_split(_encode_chunk(c, quality)) for c in chunk_imgs]
    headers = bytearray(encoded[0][0])
    # locate SOF (FFC0/FFC1) and patch dims; insert DRI before SOS
    pos = 2
    sof_off = -1
    while True:
        marker = headers[pos + 1]
        (seg_len,) = struct.unpack(">H", headers[pos + 2: pos + 4])
        if marker in (0xC0, 0xC1):
            sof_off = pos
        if marker == 0xDA:
            sos_off = pos
            break
        pos += 2 + seg_len
    assert sof_off >= 0
    struct.pack_into(">HH", headers, sof_off + 5,
                     0 if zero_sof_dims else h, 0 if zero_sof_dims else w)
    dri = struct.pack(">HHH", 0xFFDD, 4, restart)
    out = bytearray(headers[:sos_off]) + dri + headers[sos_off:]
    starts = []
    for i, (_, entropy) in enumerate(encoded):
        if i:
            out += struct.pack(">H", 0xFFD0 + ((i - 1) % 8))
        starts.append(len(out))
        out += entropy
    out += b"\xff\xd9"
    if return_mcu_starts:
        return bytes(out), starts
    return bytes(out)


def write_ndpi_like_tiff(
    path: str,
    base_image: np.ndarray,
    mpp: float = 0.228,
    objective_power: float = 40.0,
    levels: int = 1,
    rows_per_chunk: int = 1,
    chunk_mcus_w: int = 0,
    jpeg_quality: int = 90,
    zero_sof_dims: bool = False,
    mcu_starts: bool = False,
    offset_pad: int = 0,
    mcu_starts_transform=None,
) -> None:
    """Write a classic TIFF in the real Hamamatsu NDPI layout: each level
    is ONE JPEG strip (RowsPerStrip = ImageLength) with restart markers
    (VERDICT/OpenSlide: the format ``openslide.read_region`` consumes at
    detect_glomus_test.py:274).  Options mirror the quirks the readers
    must handle; see :func:`encode_ndpi_strip`.

    ``mcu_starts=True`` writes the NDPI McuStarts tag (65426): the
    strip-relative entropy offset of every restart chunk, which real
    Hamamatsu scanners precompute so readers can index a level without
    scanning its whole entropy stream.

    ``offset_pad`` inserts a sparse hole after the header before any
    payload, pushing every structure ``offset_pad`` bytes down the file.
    With a pad > 4 GiB this reproduces the real >4 GiB NDPI quirk: the
    format stays CLASSIC TIFF (Hamamatsu never writes BigTIFF; level 0
    of a 40x slide routinely exceeds 4 GiB), every stored offset is its
    true position modulo 2^32, and readers must reconstruct the high
    bits from the data-written-before-its-directory layout — the same
    fixup OpenSlide applies.  The hole is never written, so the on-disk
    cost is only the real payload (sparse file).
    """
    h, w = base_image.shape[:2]
    images = [base_image]
    for _ in range(levels - 1):
        images.append(_downsample2(images[-1]))

    den = 1_000_000
    num = int(round(10000.0 / mpp * den))
    while num >= 2**32:
        den //= 10
        num = int(round(10000.0 / mpp * den))

    def store32(off: int) -> int:
        """Stored form of a file offset: real NDPI wraps to low 32 bits."""
        if off < 2**32:
            return off
        if not offset_pad:
            raise ValueError(f"offset {off} needs offset_pad (wrap) mode")
        return off & 0xFFFFFFFF

    with open(path, "wb") as f:
        f.write(struct.pack("<2sHI", b"II", 42, 0))
        pos = 8 + offset_pad

        def alloc(data: bytes) -> int:
            nonlocal pos
            if pos % 2:
                pos += 1
            off = pos
            f.seek(off)
            f.write(data)
            pos += len(data)
            return off

        ifd_offsets: List[int] = []
        ifd_sizes: List[int] = []
        for img in images:
            lh, lw = img.shape[:2]
            strip, starts = encode_ndpi_strip(
                img, rows_per_chunk=rows_per_chunk,
                chunk_mcus_w=chunk_mcus_w, quality=jpeg_quality,
                zero_sof_dims=zero_sof_dims, return_mcu_starts=True)
            strip_off = alloc(strip)

            b = _IfdWriter()
            b.add(256, _TYPE_LONG, [lw])
            b.add(257, _TYPE_LONG, [lh])
            b.add(258, _TYPE_SHORT, [8, 8, 8])
            b.add(259, _TYPE_SHORT, [7])
            b.add(262, _TYPE_SHORT, [6])
            b.add(273, _TYPE_LONG, [store32(strip_off)])
            b.add(277, _TYPE_SHORT, [3])
            b.add(278, _TYPE_LONG, [lh])  # RowsPerStrip == ImageLength
            b.add(279, _TYPE_LONG, [len(strip)])
            b.add(282, _TYPE_RATIONAL, [(num, den)])
            b.add(283, _TYPE_RATIONAL, [(num, den)])
            b.add(296, _TYPE_SHORT, [3])
            b.add(65421, _TYPE_FLOAT, [objective_power])
            if mcu_starts:
                # mcu_starts_transform corrupts the tag for reader
                # fallback tests (e.g. a sub-RST gap); the entropy
                # stream itself stays valid
                if mcu_starts_transform is not None:
                    starts = mcu_starts_transform(list(starts))
                b.add(65426, _TYPE_LONG, starts)

            entries = sorted(b.entries)
            ifd = struct.pack("<H", len(entries))
            body = b""
            for tag, typ, cnt, payload in entries:
                if len(payload) <= 4:
                    body += struct.pack("<HHI", tag, typ,
                                        cnt) + payload.ljust(4, b"\0")
                else:
                    off = alloc(payload)
                    body += struct.pack("<HHII", tag, typ, cnt,
                                        store32(off))
            ifd += body + struct.pack("<I", 0)
            ifd_offsets.append(alloc(ifd))
            ifd_sizes.append(len(ifd))

        # patch the first-IFD pointer and the next-IFD chain
        f.seek(4)
        f.write(struct.pack("<I", store32(ifd_offsets[0])))
        for i in range(len(ifd_offsets) - 1):
            f.seek(ifd_offsets[i] + ifd_sizes[i] - 4)
            f.write(struct.pack("<I", store32(ifd_offsets[i + 1])))
