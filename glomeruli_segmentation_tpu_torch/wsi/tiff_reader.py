"""Pure-python TIFF / BigTIFF / NDPI whole-slide reader.

Replaces OpenSlide for the pipeline's slide access (reference usage:
``openslide.open_slide`` / ``read_region`` / ``properties`` /
``level_downsamples`` at e.g. ``module/faster-rcnn/detect_glomus_test.py:183-274``,
``module/espnet/test/eval_wsi_segmentation.py:351-357``).  The API mirrors
openslide so pipeline code is drop-in:

- ``Slide.dimensions`` — level-0 (width, height)
- ``Slide.level_downsamples`` / ``level_dimensions`` / ``level_count``
- ``Slide.properties`` with the openslide property names
  (``openslide.mpp-x``, ``openslide.mpp-y``, ``openslide.objective-power``)
- ``Slide.read_region((x, y), level, (w, h))`` -> RGBA PIL image, with
  ``(x, y)`` in level-0 coordinates.

Format support: classic TIFF and BigTIFF, tiled or striped, compression
none (1), JPEG (7, with shared JPEGTables merging), deflate (8), and the
NDPI flavour of TIFF (objective power / mpp from Hamamatsu private tags).

The port's own copy of ``glomeruli_segmentation_tpu/wsi/tiff_reader.py``
(the port imports nothing of the JAX package); a test holds both readers
to the same bytes.  JPEG tiles are decoded with PIL, imported at the first
decode: where PIL is missing a JPEG slide raises ``ImportError`` there.
"""
from __future__ import annotations

import io
import math
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

# TIFF tag ids
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_X_RESOLUTION = 282
TAG_Y_RESOLUTION = 283
TAG_RESOLUTION_UNIT = 296
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_JPEG_TABLES = 347
# Hamamatsu NDPI private tags
TAG_NDPI_SOURCELENS = 65421
TAG_NDPI_MPP_X = 65422  # actually XOffsetFromSlideCentre; see notes below
TAG_NDPI_MPP_Y = 65423
TAG_NDPI_MCU_STARTS = 65426  # precomputed restart-chunk entropy offsets

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
               11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q", 18: "Q"}


@dataclass
class _Page:
    width: int = 0
    height: int = 0
    tile_width: int = 0
    tile_height: int = 0
    rows_per_strip: int = 0
    compression: int = 1
    photometric: int = 2
    samples_per_pixel: int = 3
    offsets: List[int] = field(default_factory=list)
    byte_counts: List[int] = field(default_factory=list)
    jpeg_tables: Optional[bytes] = None
    x_resolution: Optional[float] = None
    y_resolution: Optional[float] = None
    resolution_unit: int = 2
    source_lens: Optional[float] = None
    mcu_starts: Optional[List[int]] = None

    @property
    def tiled(self) -> bool:
        return self.tile_width > 0


class TiffParseError(Exception):
    pass


def _plausible_ifd(f, endian: str, offset: int, file_size: int) -> bool:
    """Probe whether ``offset`` points at a sane classic-TIFF IFD: entry
    count in [1, 4096] and tag ids sorted nondecreasing (the TIFF spec
    requires sorted tags).  Used to disambiguate wrapped >4 GiB offsets."""
    if offset + 2 > file_size:
        return False
    f.seek(offset)
    head = f.read(2)
    if len(head) < 2:
        return False
    (n,) = struct.unpack(endian + "H", head)
    if not 1 <= n <= 4096:
        return False
    raw = f.read(n * 12)
    if len(raw) < n * 12:
        return False
    tags = [struct.unpack(endian + "H", raw[i * 12: i * 12 + 2])[0]
            for i in range(n)]
    return all(a <= b for a, b in zip(tags, tags[1:]))


def _data_offset_fixer(dir_pos: int):
    """Reconstruct a wrapped 32-bit data offset (out-of-line tag payload
    or strip/tile position) inside a >4 GiB classic-TIFF NDPI file.

    Real Hamamatsu NDPI stays classic TIFF past 4 GiB (level 0 of a 40x
    slide routinely is), storing every offset modulo 2^32; the scanner
    writes each directory AFTER the data it points to, so the true
    offset is the largest ``raw + k * 2^32`` not beyond the directory's
    own (already reconstructed) position — the same fixup OpenSlide
    applies.  For structures genuinely below 4 GiB this is the identity.
    """
    high = dir_pos & ~0xFFFFFFFF

    def fix(raw: int) -> int:
        cand = high | raw
        if cand > dir_pos:
            cand -= 1 << 32
        return cand if cand >= 0 else raw

    return fix


def _read_ifds(f):
    """Parse the IFD chain.  Returns ``(ifds, endian, needs_fix)`` where
    ``ifds`` is a list of ``(entries, dir_pos)``; ``needs_fix`` is True
    for a classic TIFF larger than 4 GiB (the real-NDPI layout), whose
    stored 32-bit offsets wrap and must be reconstructed — directory
    positions by forward monotonicity + a plausibility probe, data
    offsets by :func:`_data_offset_fixer`."""
    f.seek(0, 2)
    file_size = f.tell()
    f.seek(0)
    header = f.read(8)
    if header[:2] == b"II":
        endian = "<"
    elif header[:2] == b"MM":
        endian = ">"
    else:
        raise TiffParseError("not a TIFF file")
    (version,) = struct.unpack(endian + "H", header[2:4])
    big = version == 43
    if big:
        offsize, zero = struct.unpack(endian + "HH", header[4:8])
        if offsize != 8 or zero != 0:
            raise TiffParseError("malformed BigTIFF header")
        (ifd_offset,) = struct.unpack(endian + "Q", f.read(8))
        entry_size, count_fmt, off_fmt = 20, "Q", "Q"
    elif version == 42:
        (ifd_offset,) = struct.unpack(endian + "I", header[4:8])
        entry_size, count_fmt, off_fmt = 12, "H", "I"
    else:
        raise TiffParseError(f"unknown TIFF version {version}")
    needs_fix = not big and file_size > 0xFFFFFFFF

    def fix_chain(raw: int, prev_pos: int) -> int:
        """Directories appear in increasing file order; pick the smallest
        ``raw + k * 2^32`` past ``prev_pos`` that probes as an IFD."""
        if raw == 0 or not needs_fix:
            return raw
        cand = (prev_pos & ~0xFFFFFFFF) | raw
        if cand <= prev_pos:
            cand += 1 << 32
        while cand + 2 <= file_size:
            if _plausible_ifd(f, endian, cand, file_size):
                return cand
            cand += 1 << 32
        return raw  # give up; let the caller fail loudly

    ifd_offset = fix_chain(ifd_offset, 8)
    ifds = []
    while ifd_offset:
        if len(ifds) >= 1024:  # corrupt chain (cycle / runaway): fail, not hang
            raise TiffParseError("IFD chain exceeds 1024 directories")
        dir_pos = ifd_offset
        f.seek(ifd_offset)
        (n_entries,) = struct.unpack(
            endian + count_fmt, f.read(struct.calcsize(count_fmt)))
        raw = f.read(n_entries * entry_size)
        entries: Dict[int, tuple] = {}
        for i in range(n_entries):
            chunk = raw[i * entry_size: (i + 1) * entry_size]
            if big:
                tag, typ, cnt = struct.unpack(endian + "HHQ", chunk[:12])
                value_bytes = chunk[12:20]
            else:
                tag, typ, cnt = struct.unpack(endian + "HHI", chunk[:8])
                value_bytes = chunk[8:12]
            entries[tag] = (typ, cnt, value_bytes)
        (ifd_offset,) = struct.unpack(endian + off_fmt,
                                      f.read(struct.calcsize(off_fmt)))
        ifds.append((entries, dir_pos))
        ifd_offset = fix_chain(ifd_offset, dir_pos)
    return ifds, endian, needs_fix


def _tag_values(f, endian: str, entry: tuple, fix=None):
    typ, cnt, value_bytes = entry
    size = _TYPE_SIZES.get(typ)
    if size is None:
        return None
    total = size * cnt
    if total <= len(value_bytes):
        data = value_bytes[:total]
    else:
        fmt = "Q" if len(value_bytes) == 8 else "I"
        (offset,) = struct.unpack(endian + fmt, value_bytes)
        if fix is not None:
            offset = fix(offset)
        f.seek(offset)
        data = f.read(total)
    if typ == 2:  # ASCII
        return data.split(b"\0")[0].decode("ascii", "replace")
    if typ in (5, 10):  # RATIONAL
        fmt = "i" if typ == 10 else "I"
        pairs = struct.unpack(endian + fmt * (2 * cnt), data)
        return [pairs[2 * i] / pairs[2 * i + 1] if pairs[2 * i + 1] else 0.0
                for i in range(cnt)]
    if typ == 7:  # UNDEFINED
        return data
    fmt = _TYPE_FMT[typ]
    return list(struct.unpack(endian + fmt * cnt, data))


def _parse_page(f, endian: str, entries: Dict[int, tuple],
                fix=None) -> _Page:
    page = _Page()

    def get(tag, default=None):
        if tag not in entries:
            return default
        return _tag_values(f, endian, entries[tag], fix)

    def get1(tag, default=None):
        v = get(tag)
        if v is None:
            return default
        if isinstance(v, (list, tuple)):
            return v[0] if v else default
        return v

    page.width = int(get1(TAG_IMAGE_WIDTH, 0))
    page.height = int(get1(TAG_IMAGE_LENGTH, 0))
    page.compression = int(get1(TAG_COMPRESSION, 1))
    page.photometric = int(get1(TAG_PHOTOMETRIC, 2))
    page.samples_per_pixel = int(get1(TAG_SAMPLES_PER_PIXEL, 3))
    page.tile_width = int(get1(TAG_TILE_WIDTH, 0))
    page.tile_height = int(get1(TAG_TILE_LENGTH, 0))
    page.rows_per_strip = int(get1(TAG_ROWS_PER_STRIP, page.height or 1))
    if page.tiled:
        page.offsets = [int(v) for v in get(TAG_TILE_OFFSETS, [])]
        page.byte_counts = [int(v) for v in get(TAG_TILE_BYTE_COUNTS, [])]
    else:
        page.offsets = [int(v) for v in get(TAG_STRIP_OFFSETS, [])]
        page.byte_counts = [int(v) for v in get(TAG_STRIP_BYTE_COUNTS, [])]
    if len(page.byte_counts) != len(page.offsets):
        # corrupt IFD: offsets without matching byte counts would surface
        # later as a bare IndexError mid-read; fail at parse like the C++
        # reader
        raise TiffParseError(
            f"strip/tile offsets ({len(page.offsets)}) and byte counts "
            f"({len(page.byte_counts)}) disagree")
    if fix is not None:  # strip/tile positions are file offsets too
        page.offsets = [fix(v) for v in page.offsets]
    jt = get(TAG_JPEG_TABLES)
    if jt:
        page.jpeg_tables = bytes(jt)
    page.x_resolution = get1(TAG_X_RESOLUTION)
    page.y_resolution = get1(TAG_Y_RESOLUTION)
    page.resolution_unit = int(get1(TAG_RESOLUTION_UNIT, 2))
    sl = get1(TAG_NDPI_SOURCELENS)
    if sl is not None:
        page.source_lens = float(sl)
    ms = get(TAG_NDPI_MCU_STARTS)
    if ms:
        page.mcu_starts = [int(v) for v in ms]
    return page


def _decode_jpeg(data: bytes) -> np.ndarray:
    from PIL import Image

    img = Image.open(io.BytesIO(data))
    return np.asarray(img.convert("RGB"))


class _NdpiStripIndex:
    """Virtual tile grid over a single-strip JPEG level (real-NDPI layout).

    Hamamatsu NDPI stores each pyramid level as ONE JPEG strip
    (RowsPerStrip == ImageLength) with restart markers, consumed by the
    reference through ``openslide.read_region``
    (module/faster-rcnn/detect_glomus_test.py:274,
    module/espnet/test/eval_wsi_segmentation.py:351-357).  Decoding the
    whole strip per read would touch the entire multi-gigapixel level, so
    this index restores random access:

    - parse the JPEG headers once: SOF dims + sampling factors give the
      MCU geometry, DRI gives the restart interval R (in MCUs);
    - scan the entropy stream once for RST markers and cache each
      restart-chunk's byte span (every chunk starts with fresh DC
      predictors, so it decodes independently);
    - map chunks onto a virtual tile grid: R == MCUs-per-row makes a
      chunk one full MCU row; R < MCUs-per-row (the layout Hamamatsu
      uses for levels wider than JPEG's 65,500 px limit, whose SOF
      records 0x0 dims) makes it a horizontal segment of a row;
    - a ``read_region`` decodes only the touched chunks, each via a
      synthesized mini-JPEG: original headers with the SOF patched to
      the chunk's pixel dims and DRI zeroed, the chunk's entropy bytes,
      EOI.

    Cost per window is O(window area), independent of slide height —
    matching OpenSlide's NDPI behavior the reference relies on.
    """

    def __init__(self, data_reader, strip_offset: int, strip_size: int,
                 page_width: int, page_height: int,
                 mcu_starts: Optional[List[int]] = None):
        # data_reader(offset, size) -> bytes within the strip
        self._read = data_reader
        self._base = strip_offset
        self._size = strip_size
        self.ok = False
        self.width = page_width
        self.height = page_height
        self.used_mcu_starts = False
        try:
            self._parse_headers()
            self._build_grid()
            use_tag = False
            if mcu_starts:
                try:
                    use_tag = self._spans_from_mcu_starts(mcu_starts)
                except Exception:
                    # a deviant tag must never cost the whole index —
                    # the scan fallback is the documented contract
                    use_tag = False
            if use_tag:
                self.used_mcu_starts = True
            else:
                self._scan_markers()
            self.ok = (len(self.chunk_spans) == self.n_chunks)
        except Exception:
            self.ok = False

    # -- header parse ---------------------------------------------------
    def _parse_headers(self):
        head = self._read(self._base, min(1 << 16, self._size))
        if head[:2] != b"\xff\xd8":
            raise TiffParseError("not a JPEG strip")
        pos = 2
        self.sof_off = -1
        self.dri_off = -1
        self.restart_interval = 0
        sof_w = sof_h = 0
        while True:
            if pos + 4 > len(head):
                head += self._read(self._base + len(head),
                                   min(1 << 16, self._size - len(head)))
            if head[pos] != 0xFF:
                raise TiffParseError("bad marker sync")
            marker = head[pos + 1]
            if marker in (0xC0, 0xC1):  # baseline / extended sequential SOF
                (seg_len, _prec, sof_h, sof_w) = struct.unpack(
                    ">HBHH", head[pos + 2: pos + 9])
                ncomp = head[pos + 9]
                hmax = vmax = 1
                for c in range(ncomp):
                    samp = head[pos + 11 + 3 * c]
                    hmax = max(hmax, samp >> 4)
                    vmax = max(vmax, samp & 0xF)
                self.mcu_w, self.mcu_h = 8 * hmax, 8 * vmax
                self.sof_off = pos
                pos += 2 + seg_len
            elif marker == 0xC2:  # progressive: no chunked random access
                raise TiffParseError("progressive JPEG strip")
            elif marker == 0xDD:  # DRI
                self.dri_off = pos
                self.restart_interval = struct.unpack(
                    ">H", head[pos + 4: pos + 6])[0]
                pos += 6
            elif marker == 0xDA:  # SOS: entropy data follows
                (seg_len,) = struct.unpack(">H", head[pos + 2: pos + 4])
                pos += 2 + seg_len
                self.headers = bytes(head[:pos])
                self.entropy_start = pos
                return
            elif marker == 0xD8 or 0xD0 <= marker <= 0xD7:
                pos += 2
            else:
                (seg_len,) = struct.unpack(">H", head[pos + 2: pos + 4])
                pos += 2 + seg_len
        # unreachable
        raise TiffParseError("no SOS marker")

    def _build_grid(self):
        # SOF dims of 0 mean "wider/taller than 65,500 px — true dims live
        # in the TIFF tags" (the NDPI giant-level trick)
        if self.sof_off < 0 or self.restart_interval <= 0:
            raise TiffParseError("no SOF/DRI")
        mpr = -(-self.width // self.mcu_w)   # MCUs per row
        mrows = -(-self.height // self.mcu_h)
        r = self.restart_interval
        if r % mpr == 0:
            self.tile_w = self.width
            self.tile_h = (r // mpr) * self.mcu_h
            self.tiles_across = 1
        elif mpr % r == 0:
            self.tile_w = r * self.mcu_w
            self.tile_h = self.mcu_h
            self.tiles_across = mpr // r
        else:
            raise TiffParseError(
                f"restart interval {r} does not tile {mpr} MCUs/row")
        self.tiles_down = -(-self.height // self.tile_h)
        self.n_chunks = -(-(mpr * mrows) // r)

    def _spans_from_mcu_starts(self, starts: List[int]) -> bool:
        """Chunk spans from the NDPI McuStarts tag (65426): the
        strip-relative offset of every restart chunk's first entropy byte,
        precomputed by the scanner.  Using it makes index construction
        O(chunks) instead of a sequential scan of the whole (multi-GB at
        level 0) entropy stream.  The tag convention is validated against
        the header-derived grid — entry count, monotonicity, first entry ==
        entropy start, and an RST marker immediately before sampled
        entries; any mismatch returns False and the caller falls back to
        the marker scan, so a file whose tag deviates stays correct."""
        if len(starts) != self.n_chunks or starts[0] != self.entropy_start:
            return False
        # entries must be strictly increasing by >= 2: each chunk ends
        # with a 2-byte RST marker, so a smaller gap is impossible in a
        # real file and would invert the span arithmetic (end = next - 2)
        if any(b - a < 2 for a, b in zip(starts, starts[1:])):
            return False
        if starts[-1] >= self._size:
            return False
        for j in {1, len(starts) // 2, len(starts) - 1}:
            if j <= 0 or j >= len(starts):  # single-chunk level: no probes
                continue
            mk = self._read(self._base + starts[j] - 2, 2)
            if len(mk) != 2 or mk[0] != 0xFF or not 0xD0 <= mk[1] <= 0xD7:
                return False
        ends = [s - 2 for s in starts[1:]]
        tail = self._read(self._base + self._size - 2, 2)
        ends.append(self._size - 2 if tail == b"\xff\xd9" else self._size)
        self.chunk_spans = list(zip(starts, ends))
        return True

    def _scan_markers(self):
        """One sequential pass over the entropy stream; chunk_spans[j] =
        (start, end) byte offsets (strip-relative) of chunk j's entropy
        bytes (end excludes the following RST marker)."""
        spans = []
        start = self.entropy_start
        pos = self.entropy_start
        block = 1 << 22
        carry = b""
        file_pos = pos
        while file_pos < self._size:
            want = min(block, self._size - file_pos)
            chunk = self._read(self._base + file_pos, want)
            data = carry + chunk
            base = file_pos - len(carry)
            i = 0
            limit = len(data) - 1
            while True:
                i = data.find(b"\xff", i)
                if i < 0 or i >= limit:
                    break
                m = data[i + 1]
                if 0xD0 <= m <= 0xD7:
                    spans.append((start, base + i))
                    start = base + i + 2
                    i += 2
                elif m == 0xD9:  # EOI
                    spans.append((start, base + i))
                    self.chunk_spans = spans
                    return
                else:
                    i += 1 if m == 0x00 or m == 0xFF else 2
            if len(chunk) < want:
                # short read: StripByteCounts overstates the file (truncated
                # slide) — stop instead of spinning on a non-advancing pos
                break
            carry = data[-1:]
            file_pos = base + len(data)
        # no EOI: treat end of strip as final chunk end
        spans.append((start, self._size))
        self.chunk_spans = spans

    # -- chunk decode ---------------------------------------------------
    def tile_pixel_dims(self, tx: int, ty: int) -> Tuple[int, int]:
        w = min(self.tile_w, self.width - tx * self.tile_w)
        h = min(self.tile_h, self.height - ty * self.tile_h)
        return w, h

    def chunk_jpeg(self, index: int) -> bytes:
        """Synthesize a standalone JPEG for chunk ``index``."""
        ty, tx = divmod(index, self.tiles_across)
        w, h = self.tile_pixel_dims(tx, ty)
        head = bytearray(self.headers)
        struct.pack_into(">HH", head, self.sof_off + 5, h, w)
        if self.dri_off >= 0:
            struct.pack_into(">H", head, self.dri_off + 4, 0)
        s, e = self.chunk_spans[index]
        body = self._read(self._base + s, e - s)
        return bytes(head) + body + b"\xff\xd9"


class Slide:
    """Pyramidal whole-slide image with openslide-like access."""

    def __init__(self, path: str, tile_cache_size: int = 64):
        self.path = path
        self._f = open(path, "rb")
        ifds, self._endian, needs_fix = _read_ifds(self._f)
        pages = [
            _parse_page(self._f, self._endian, entries,
                        _data_offset_fixer(dir_pos) if needs_fix else None)
            for entries, dir_pos in ifds]
        # keep only pyramid pages (full-resolution aspect ratio); NDPI also
        # stores a macro image and a map image with source_lens < 0
        pages = [p for p in pages if p.width > 0 and p.height > 0
                 and (p.source_lens is None or p.source_lens > 0)]
        if not pages:
            raise TiffParseError(f"no image pages in {path}")
        pages.sort(key=lambda p: -(p.width * p.height))
        base = pages[0]
        self._pages = [p for p in pages
                       if abs(p.width / p.height - base.width / base.height)
                       < 0.05]
        self._tile_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._tile_cache_size = tile_cache_size
        # level -> _NdpiStripIndex | None; built lazily on first touch of a
        # single-strip JPEG level (real-NDPI layout)
        self._ndpi_indices: Dict[int, Optional[_NdpiStripIndex]] = {}
        self.chunk_decodes = 0  # instrumentation (tests assert O(window))
        self.properties = self._build_properties()

    # ---------------- openslide-compatible surface ----------------
    @property
    def dimensions(self) -> Tuple[int, int]:
        return (self._pages[0].width, self._pages[0].height)

    @property
    def level_count(self) -> int:
        return len(self._pages)

    @property
    def level_dimensions(self) -> List[Tuple[int, int]]:
        return [(p.width, p.height) for p in self._pages]

    @property
    def level_downsamples(self) -> List[float]:
        w0 = self._pages[0].width
        return [w0 / p.width for p in self._pages]

    def get_best_level_for_downsample(self, downsample: float) -> int:
        best = 0
        for i, d in enumerate(self.level_downsamples):
            if d <= downsample + 1e-6:
                best = i
        return best

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def _build_properties(self) -> Dict[str, str]:
        props: Dict[str, str] = {}
        base = self._pages[0]
        if base.x_resolution:
            unit_um = {2: 25400.0, 3: 10000.0}.get(base.resolution_unit)
            if unit_um:
                props["openslide.mpp-x"] = str(unit_um / base.x_resolution)
                props["openslide.mpp-y"] = str(
                    unit_um / (base.y_resolution or base.x_resolution))
        if base.source_lens is not None:
            props["openslide.objective-power"] = str(int(base.source_lens))
        props["openslide.level-count"] = str(self.level_count)
        for i, (w, h) in enumerate(self.level_dimensions):
            props[f"openslide.level[{i}].width"] = str(w)
            props[f"openslide.level[{i}].height"] = str(h)
            props[f"openslide.level[{i}].downsample"] = str(
                self.level_downsamples[i])
        return props

    # ---------------- pixel access ----------------
    def _ndpi_index(self, level: int) -> Optional[_NdpiStripIndex]:
        """Build (once) the restart-marker virtual-tile index for a
        single-strip JPEG level; None when the level is not laid out that
        way (tiled, multi-strip, non-JPEG or unparseable)."""
        if level in self._ndpi_indices:
            return self._ndpi_indices[level]
        page = self._pages[level]
        idx = None
        # byte_counts guards mirror the C++ reader: a corrupt IFD may carry
        # STRIP_OFFSETS without (or with an implausible) STRIP_BYTE_COUNTS
        if (not page.tiled and page.compression == 7
                and len(page.offsets) == 1
                and len(page.byte_counts) == 1
                and 0 < page.byte_counts[0]
                <= os.fstat(self._f.fileno()).st_size
                and page.rows_per_strip >= page.height
                and not page.jpeg_tables):

            def read_at(offset, size):
                self._f.seek(offset)
                return self._f.read(size)

            built = _NdpiStripIndex(read_at, page.offsets[0],
                                    page.byte_counts[0], page.width,
                                    page.height,
                                    mcu_starts=page.mcu_starts)
            if built.ok:
                idx = built
        self._ndpi_indices[level] = idx
        return idx

    def _read_ndpi_tile(self, level: int, idx: _NdpiStripIndex,
                        index: int) -> np.ndarray:
        key = (level, index)
        cached = self._tile_cache.get(key)
        if cached is not None:
            return cached
        arr = _decode_jpeg(idx.chunk_jpeg(index))
        self.chunk_decodes += 1
        if len(self._tile_cache) >= self._tile_cache_size:
            self._tile_cache.pop(next(iter(self._tile_cache)))
        self._tile_cache[key] = arr
        return arr

    def _read_chunk(self, level: int, index: int) -> np.ndarray:
        key = (level, index)
        cached = self._tile_cache.get(key)
        if cached is not None:
            return cached
        page = self._pages[level]
        self._f.seek(page.offsets[index])
        data = self._f.read(page.byte_counts[index])
        if page.compression == 7:  # JPEG
            if page.jpeg_tables and len(page.jpeg_tables) > 4:
                # merge shared quant/huffman tables: tables stream minus EOI,
                # tile stream minus SOI
                data = page.jpeg_tables[:-2] + data[2:]
            arr = _decode_jpeg(data)
        elif page.compression == 8:  # deflate
            import zlib

            raw = zlib.decompress(data)
            arr = self._raw_to_array(page, index, raw)
        elif page.compression == 1:
            arr = self._raw_to_array(page, index, data)
        else:
            raise TiffParseError(
                f"unsupported compression {page.compression}")
        if len(self._tile_cache) >= self._tile_cache_size:
            self._tile_cache.pop(next(iter(self._tile_cache)))
        self._tile_cache[key] = arr
        return arr

    def _raw_to_array(self, page: _Page, index: int, raw: bytes) -> np.ndarray:
        spp = page.samples_per_pixel
        if page.tiled:
            h, w = page.tile_height, page.tile_width
        else:
            rows = min(page.rows_per_strip,
                       page.height - index * page.rows_per_strip)
            h, w = rows, page.width
        arr = np.frombuffer(raw, dtype=np.uint8, count=h * w * spp)
        arr = arr.reshape(h, w, spp)
        if spp == 1:
            arr = np.repeat(arr, 3, axis=2)
        return arr[:, :, :3]

    def read_region_array(self, location: Tuple[int, int], level: int,
                          size: Tuple[int, int]) -> np.ndarray:
        """RGB uint8 array; out-of-bounds pixels are white (slide background)."""
        x0_l0, y0_l0 = location
        w, h = size
        page = self._pages[level]
        ds = self.level_downsamples[level]
        x0 = int(x0_l0 / ds)
        y0 = int(y0_l0 / ds)
        out = np.full((h, w, 3), 255, dtype=np.uint8)

        ix0, iy0 = max(x0, 0), max(y0, 0)
        ix1, iy1 = min(x0 + w, page.width), min(y0 + h, page.height)
        if ix1 <= ix0 or iy1 <= iy0:
            return out

        ndpi = None if page.tiled else self._ndpi_index(level)
        if page.tiled or ndpi is not None:
            if ndpi is not None:
                tw, th, tiles_across = (ndpi.tile_w, ndpi.tile_h,
                                        ndpi.tiles_across)
            else:
                tw, th = page.tile_width, page.tile_height
                tiles_across = math.ceil(page.width / tw)
            for ty in range(iy0 // th, (iy1 - 1) // th + 1):
                for tx in range(ix0 // tw, (ix1 - 1) // tw + 1):
                    index = ty * tiles_across + tx
                    if ndpi is not None:
                        tile = self._read_ndpi_tile(level, ndpi, index)
                    else:
                        tile = self._read_chunk(level, index)
                    sx0 = max(ix0, tx * tw)
                    sy0 = max(iy0, ty * th)
                    sx1 = min(ix1, (tx + 1) * tw)
                    sy1 = min(iy1, (ty + 1) * th)
                    out[sy0 - y0: sy1 - y0, sx0 - x0: sx1 - x0] = tile[
                        sy0 - ty * th: sy1 - ty * th,
                        sx0 - tx * tw: sx1 - tx * tw]
        else:
            rps = page.rows_per_strip
            for strip in range(iy0 // rps, (iy1 - 1) // rps + 1):
                arr = self._read_chunk(level, strip)
                sy0 = max(iy0, strip * rps)
                sy1 = min(iy1, strip * rps + arr.shape[0])
                out[sy0 - y0: sy1 - y0, ix0 - x0: ix1 - x0] = arr[
                    sy0 - strip * rps: sy1 - strip * rps, ix0: ix1]
        return out

    def read_region(self, location: Tuple[int, int], level: int,
                    size: Tuple[int, int]):
        """openslide-compatible: returns an RGBA PIL image."""
        from PIL import Image

        rgb = self.read_region_array(location, level, size)
        rgba = np.dstack([rgb, np.full(rgb.shape[:2], 255, np.uint8)])
        return Image.fromarray(rgba, mode="RGBA")
