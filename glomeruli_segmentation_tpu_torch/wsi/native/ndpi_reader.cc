// Native whole-slide reader: TIFF / BigTIFF / NDPI pyramids.
//
// Replacement for the OpenSlide C library the reference links
// against (docker/gpu.dockerfile:9,36; used from e.g.
// module/faster-rcnn/detect_glomus_test.py:183-190).  Parses IFDs directly,
// decodes JPEG tiles/strips with libjpeg(-turbo) (merging shared
// JPEGTables), deflate with zlib, and exposes a flat C ABI consumed by the
// ctypes wrapper in ../native_reader.py.  Tile decodes for one read_region
// fan out over a small thread pool, and the caller's ctypes call releases
// the GIL, so crop reads overlap the host threads that stage batches for
// the GPU.
//
// Build: _build.py next to this file compiles it at first use, against the
// libjpeg and zlib headers under include/.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

#include <jpeglib.h>
#include <zlib.h>
#include <csetjmp>

namespace {

constexpr uint16_t TAG_IMAGE_WIDTH = 256;
constexpr uint16_t TAG_IMAGE_LENGTH = 257;
constexpr uint16_t TAG_COMPRESSION = 259;
constexpr uint16_t TAG_STRIP_OFFSETS = 273;
constexpr uint16_t TAG_SAMPLES_PER_PIXEL = 277;
constexpr uint16_t TAG_ROWS_PER_STRIP = 278;
constexpr uint16_t TAG_STRIP_BYTE_COUNTS = 279;
constexpr uint16_t TAG_X_RESOLUTION = 282;
constexpr uint16_t TAG_Y_RESOLUTION = 283;
constexpr uint16_t TAG_RESOLUTION_UNIT = 296;
constexpr uint16_t TAG_TILE_WIDTH = 322;
constexpr uint16_t TAG_TILE_LENGTH = 323;
constexpr uint16_t TAG_TILE_OFFSETS = 324;
constexpr uint16_t TAG_TILE_BYTE_COUNTS = 325;
constexpr uint16_t TAG_JPEG_TABLES = 347;
constexpr uint16_t TAG_NDPI_SOURCELENS = 65421;
// Precomputed restart-chunk entropy offsets (strip-relative), written by
// Hamamatsu scanners so readers can index a level without scanning its
// whole entropy stream.  Validated before use; see spans_from_mcu_starts.
constexpr uint16_t TAG_NDPI_MCU_STARTS = 65426;

struct Page {
  int64_t width = 0, height = 0;
  int64_t tile_width = 0, tile_height = 0;
  int64_t rows_per_strip = 0;
  int compression = 1;
  int samples_per_pixel = 3;
  std::vector<uint64_t> offsets;
  std::vector<uint64_t> byte_counts;
  std::vector<uint8_t> jpeg_tables;
  double x_resolution = 0, y_resolution = 0;
  int resolution_unit = 2;
  double source_lens = -1e9;  // unset marker
  std::vector<uint64_t> mcu_starts;
  bool tiled() const { return tile_width > 0; }
};

struct Entry {
  uint16_t type;
  uint64_t count;
  uint8_t inline_value[8];
  uint64_t value_offset;
  bool is_inline;
};

// Virtual tile grid over a single-strip JPEG level — the real Hamamatsu
// NDPI layout (RowsPerStrip == ImageLength, restart markers every R MCUs;
// levels wider than JPEG's 65,500 px limit record 0x0 in the SOF and the
// true dims live in the TIFF tags).  Mirrors _NdpiStripIndex in
// ../tiff_reader.py, the tested ground truth; replaces the OpenSlide
// behavior the reference consumes at detect_glomus_test.py:274.
struct NdpiIndex {
  bool ok = false;
  std::vector<uint8_t> headers;  // SOI .. end of SOS header
  size_t sof_off = 0;            // offset of FFC0/FFC1 within headers
  ptrdiff_t dri_off = -1;
  int mcu_w = 8, mcu_h = 8;
  uint32_t restart_interval = 0;
  int64_t tile_w = 0, tile_h = 0, tiles_across = 0, tiles_down = 0;
  int64_t n_chunks = 0;
  bool used_mcu_starts = false;
  // strip-relative (start, end) of each chunk's entropy bytes
  std::vector<std::pair<uint64_t, uint64_t>> spans;

  void tile_pixel_dims(int64_t width, int64_t height, int64_t tx, int64_t ty,
                       int64_t* w, int64_t* h) const {
    *w = std::min<int64_t>(tile_w, width - tx * tile_w);
    *h = std::min<int64_t>(tile_h, height - ty * tile_h);
  }
};

size_t type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
    default: return 0;
  }
}

class Reader {
 public:
  bool open(const char* path) {
    f_ = std::fopen(path, "rb");
    if (!f_) return false;
    uint8_t header[16];
    if (std::fread(header, 1, 8, f_) != 8) return false;
    if (header[0] == 'I' && header[1] == 'I') little_ = true;
    else if (header[0] == 'M' && header[1] == 'M') little_ = false;
    else return false;
    uint16_t version = rd16(header + 2);
    uint64_t ifd_offset;
    if (version == 43) {
      big_ = true;
      uint8_t rest[8];
      if (std::fread(rest, 1, 8, f_) != 8) return false;
      ifd_offset = rd64(rest);
    } else if (version == 42) {
      big_ = false;
      ifd_offset = rd32(header + 4);
    } else {
      return false;
    }
    // Real NDPI stays CLASSIC TIFF past 4 GiB (level 0 of a 40x slide
    // routinely is): stored 32-bit offsets wrap and must be reconstructed
    // — directory positions by forward monotonicity + an IFD-shape probe,
    // data offsets from the data-written-before-its-directory layout
    // (fix_data_offset) — the same fixup OpenSlide applies.  For files
    // whose structures are genuinely below 4 GiB this is the identity.
    std::fseek(f_, 0, SEEK_END);
    file_size_ = (uint64_t)std::ftell(f_);
    needs_fix_ = !big_ && file_size_ > 0xFFFFFFFFull;
    ifd_offset = fix_chain_offset(ifd_offset, 8);
    while (ifd_offset != 0) {
      // corrupt chain (cycle / runaway): fail instead of hanging
      if (pages_.size() >= 1024) return false;
      uint64_t cur = ifd_offset, next_raw = 0;
      if (!parse_ifd(cur, &next_raw)) return false;
      ifd_offset = fix_chain_offset(next_raw, cur);
    }
    // keep pyramid pages: same aspect ratio as the largest page, positive
    // source lens (NDPI macro/map images have negative lens values)
    if (pages_.empty()) return false;
    size_t base = 0;
    for (size_t i = 1; i < pages_.size(); i++)
      if (pages_[i].width * pages_[i].height >
          pages_[base].width * pages_[base].height)
        base = i;
    double ar = double(pages_[base].width) / pages_[base].height;
    std::vector<Page> keep;
    for (auto& p : pages_) {
      if (p.width <= 0 || p.height <= 0) continue;
      if (p.source_lens > -1e8 && p.source_lens <= 0) continue;
      double a = double(p.width) / p.height;
      if (a / ar > 1.05 || ar / a > 1.05) continue;
      keep.push_back(std::move(p));
    }
    pages_ = std::move(keep);
    std::sort(pages_.begin(), pages_.end(), [](const Page& a, const Page& b) {
      return a.width * a.height > b.width * b.height;
    });
    return !pages_.empty();
  }

  ~Reader() {
    if (f_) std::fclose(f_);
  }

  int level_count() const { return (int)pages_.size(); }
  const Page& page(int level) const { return pages_[level]; }

  double mpp(bool x_axis) const {
    const Page& p = pages_[0];
    double res = x_axis ? p.x_resolution : p.y_resolution;
    if (res <= 0) return 0;
    double unit_um = p.resolution_unit == 3 ? 10000.0
                     : p.resolution_unit == 2 ? 25400.0 : 0.0;
    return unit_um > 0 ? unit_um / res : 0;
  }

  double objective() const {
    return pages_[0].source_lens > -1e8 ? pages_[0].source_lens : 0;
  }

  // Restart-marker virtual-tile index for a single-strip JPEG level;
  // built once on first touch (call before fanning decode jobs out to
  // threads), nullptr when the level is not laid out that way.
  const NdpiIndex* ndpi_index(int level) {
    std::lock_guard<std::mutex> lock(ndpi_mu_);
    auto it = ndpi_.find(level);
    if (it != ndpi_.end()) return it->second->ok ? it->second.get() : nullptr;
    auto idx = std::make_unique<NdpiIndex>();
    const Page& p = pages_[level];
    if (!p.tiled() && p.compression == 7 && p.offsets.size() == 1 &&
        p.byte_counts.size() == 1 && p.byte_counts[0] > 0 &&
        p.byte_counts[0] <= file_size_ &&
        p.rows_per_strip >= p.height && p.jpeg_tables.size() <= 4) {
      build_ndpi_index(p, idx.get());
    }
    const NdpiIndex* out = idx->ok ? idx.get() : nullptr;
    ndpi_[level] = std::move(idx);
    return out;
  }

  int64_t chunk_decodes() const { return chunk_decodes_.load(); }

  // Decode chunk `index` of `level` into an RGB buffer (returned via cache).
  std::shared_ptr<std::vector<uint8_t>> chunk(int level, int64_t index,
                                              int64_t* cw, int64_t* ch) {
    const Page& p = pages_[level];
    if (index < 0) return nullptr;
    const NdpiIndex* nd = nullptr;
    {
      std::lock_guard<std::mutex> lock(ndpi_mu_);
      auto it = ndpi_.find(level);
      if (it != ndpi_.end() && it->second->ok) nd = it->second.get();
    }
    if (nd) {
      int64_t tx = index % nd->tiles_across, ty = index / nd->tiles_across;
      nd->tile_pixel_dims(p.width, p.height, tx, ty, cw, ch);
    } else if (p.tiled()) {
      *cw = p.tile_width;
      *ch = p.tile_height;
    } else {
      *cw = p.width;
      int64_t row0 = index * p.rows_per_strip;
      *ch = std::min<int64_t>(p.rows_per_strip, p.height - row0);
    }
    // corrupt tags can yield empty/negative chunk geometry or absurd
    // pixel counts; fail the read instead of allocating on faith.  The
    // 2^27-px cap (~400 MB decoded) is ~10x the largest real chunk (a
    // 400k-px-wide NDPI level-0 virtual strip of 32 MCU rows) while
    // keeping a tiny corrupt file from demanding a multi-GB zero-fill
    // (overcommitting Linux OOM-kills that instead of throwing).
    if (*cw <= 0 || *ch <= 0 ||
        (uint64_t)*cw * (uint64_t)*ch > (1ull << 27))
      return nullptr;
    if (nd) {
      {
        std::lock_guard<std::mutex> lock(cache_mu_);
        auto it = cache_.find({level, index});
        if (it != cache_.end()) return it->second;
      }
      auto out = decode_ndpi_chunk(p, *nd, index, *cw, *ch);
      if (!out) return nullptr;
      chunk_decodes_.fetch_add(1);
      {
        std::lock_guard<std::mutex> lock(cache_mu_);
        if (cache_.size() > 256) cache_.clear();
        cache_[{level, index}] = out;
      }
      return out;
    }
    // a corrupt tile/strip grid can index past the offset tables, and a
    // corrupt byte count can demand a larger-than-file allocation
    if ((uint64_t)index >= p.offsets.size() ||
        (uint64_t)index >= p.byte_counts.size() ||
        p.byte_counts[index] > file_size_)
      return nullptr;
    {
      std::lock_guard<std::mutex> lock(cache_mu_);
      auto it = cache_.find({level, index});
      if (it != cache_.end()) return it->second;
    }
    std::vector<uint8_t> raw(p.byte_counts[index]);
    {
      std::lock_guard<std::mutex> lock(file_mu_);
      if (std::fseek(f_, (long)p.offsets[index], SEEK_SET) != 0) return nullptr;
      if (std::fread(raw.data(), 1, raw.size(), f_) != raw.size())
        return nullptr;
    }
    auto out = std::make_shared<std::vector<uint8_t>>((*cw) * (*ch) * 3);
    bool ok = false;
    if (p.compression == 7) {
      ok = decode_jpeg(p, raw, out->data(), *cw, *ch);
    } else if (p.compression == 1) {
      ok = copy_raw(p, raw, out->data(), *cw, *ch);
    } else if (p.compression == 8) {
      std::vector<uint8_t> inflated((*cw) * (*ch) * p.samples_per_pixel);
      uLongf dest_len = inflated.size();
      if (uncompress(inflated.data(), &dest_len, raw.data(), raw.size())
          == Z_OK) {
        ok = copy_raw(p, inflated, out->data(), *cw, *ch);
      }
    }
    if (!ok) return nullptr;
    {
      std::lock_guard<std::mutex> lock(cache_mu_);
      if (cache_.size() > 256) cache_.clear();
      cache_[{level, index}] = out;
    }
    return out;
  }

 private:
  struct JpegError {
    jpeg_error_mgr mgr;
    jmp_buf jump;
  };

  static void jpeg_error_exit(j_common_ptr cinfo) {
    JpegError* err = reinterpret_cast<JpegError*>(cinfo->err);
    longjmp(err->jump, 1);
  }

  bool decode_jpeg(const Page& p, const std::vector<uint8_t>& data,
                   uint8_t* out, int64_t cw, int64_t ch) {
    std::vector<uint8_t> merged;
    const uint8_t* src = data.data();
    size_t src_len = data.size();
    // a < 2-byte chunk cannot carry the SOI the merge splices after;
    // skip the merge and let the header parse fail cleanly
    if (p.jpeg_tables.size() > 4 && data.size() >= 2) {
      merged.reserve(p.jpeg_tables.size() - 2 + data.size() - 2);
      merged.insert(merged.end(), p.jpeg_tables.begin(),
                    p.jpeg_tables.end() - 2);
      merged.insert(merged.end(), data.begin() + 2, data.end());
      src = merged.data();
      src_len = merged.size();
    }
    jpeg_decompress_struct cinfo;
    JpegError jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_error_exit;
    // constructed BEFORE setjmp: an error longjmp would skip the
    // destructor of anything initialized after it (leak on every
    // malformed JPEG)
    std::vector<uint8_t> row;
    if (setjmp(jerr.jump)) {
      jpeg_destroy_decompress(&cinfo);
      return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(src), src_len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    int64_t w = std::min<int64_t>(cinfo.output_width, cw);
    row.resize((size_t)cinfo.output_width * 3);
    JSAMPROW rowptr = row.data();
    for (int64_t y = 0; y < (int64_t)cinfo.output_height; y++) {
      jpeg_read_scanlines(&cinfo, &rowptr, 1);
      if (y < ch) std::memcpy(out + y * cw * 3, row.data(), w * 3);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
  }

  bool read_at(uint64_t offset, size_t size, uint8_t* out) {
    std::lock_guard<std::mutex> lock(file_mu_);
    if (std::fseek(f_, (long)offset, SEEK_SET) != 0) return false;
    return std::fread(out, 1, size, f_) == size;
  }

  // Parse the strip's JPEG headers (SOF -> MCU geometry, DRI -> restart
  // interval), then scan the entropy stream once for RST markers and
  // record each chunk's byte span.  See NdpiIndex.
  void build_ndpi_index(const Page& p, NdpiIndex* idx) {
    uint64_t base = p.offsets[0];
    uint64_t size = p.byte_counts[0];
    // -- headers ------------------------------------------------------
    std::vector<uint8_t> head(std::min<uint64_t>(size, 1 << 16));
    if (head.size() < 4 || !read_at(base, head.size(), head.data())) return;
    if (head[0] != 0xFF || head[1] != 0xD8) return;
    size_t pos = 2;
    int64_t sof_off = -1;
    uint16_t sof_w = 0, sof_h = 0;
    auto be16 = [&](size_t at) -> uint16_t {
      return (uint16_t)(head[at] << 8 | head[at + 1]);
    };
    // grow the header buffer until byte index `need - 1` is readable;
    // false when the strip genuinely ends first (malformed/truncated)
    auto ensure = [&](size_t need) -> bool {
      while (need > head.size()) {
        size_t grown = std::min<uint64_t>(
            size, std::max<uint64_t>(need, head.size() + (1 << 16)));
        if (grown <= head.size()) return false;
        size_t old = head.size();
        head.resize(grown);
        if (!read_at(base + old, grown - old, head.data() + old)) {
          head.resize(old);
          return false;
        }
      }
      return true;
    };
    while (true) {
      if (!ensure(pos + 10)) return;
      if (head[pos] != 0xFF) return;
      uint8_t marker = head[pos + 1];
      if (marker == 0xC0 || marker == 0xC1) {
        uint16_t seg_len = be16(pos + 2);
        sof_h = be16(pos + 5);
        sof_w = be16(pos + 7);
        int ncomp = head[pos + 9];
        if (!ensure(pos + 11 + 3 * (size_t)ncomp)) return;
        int hmax = 1, vmax = 1;
        for (int c = 0; c < ncomp; c++) {
          uint8_t samp = head[pos + 11 + 3 * c];
          hmax = std::max(hmax, samp >> 4);
          vmax = std::max(vmax, samp & 0xF);
        }
        idx->mcu_w = 8 * hmax;
        idx->mcu_h = 8 * vmax;
        sof_off = (int64_t)pos;
        pos += 2 + seg_len;
      } else if (marker == 0xC2) {
        return;  // progressive: no chunked random access
      } else if (marker == 0xDD) {
        idx->dri_off = (ptrdiff_t)pos;
        idx->restart_interval = be16(pos + 4);
        pos += 6;
      } else if (marker == 0xDA) {
        uint16_t seg_len = be16(pos + 2);
        pos += 2 + seg_len;
        if (!ensure(pos)) return;
        idx->headers.assign(head.begin(), head.begin() + pos);
        break;
      } else if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7)) {
        pos += 2;
      } else {
        pos += 2 + be16(pos + 2);
      }
    }
    (void)sof_w;
    (void)sof_h;  // SOF dims of 0 mean "true dims in the TIFF tags"
    if (sof_off < 0 || idx->restart_interval == 0) return;
    idx->sof_off = (size_t)sof_off;
    // -- grid ---------------------------------------------------------
    int64_t mpr = (p.width + idx->mcu_w - 1) / idx->mcu_w;
    int64_t mrows = (p.height + idx->mcu_h - 1) / idx->mcu_h;
    int64_t r = idx->restart_interval;
    if (r % mpr == 0) {
      idx->tile_w = p.width;
      idx->tile_h = (r / mpr) * idx->mcu_h;
      idx->tiles_across = 1;
    } else if (mpr % r == 0) {
      idx->tile_w = r * idx->mcu_w;
      idx->tile_h = idx->mcu_h;
      idx->tiles_across = mpr / r;
    } else {
      return;
    }
    idx->tiles_down = (p.height + idx->tile_h - 1) / idx->tile_h;
    idx->n_chunks = (mpr * mrows + r - 1) / r;
    // -- precomputed McuStarts tag (validated; else fall back to scan) --
    if (!p.mcu_starts.empty() && spans_from_mcu_starts(p, idx)) {
      idx->used_mcu_starts = true;
      idx->ok = (int64_t)idx->spans.size() == idx->n_chunks;
      return;
    }
    // -- entropy scan (one sequential pass) ---------------------------
    uint64_t entropy_start = idx->headers.size();
    uint64_t start = entropy_start, file_pos = entropy_start;
    const size_t block = 1 << 22;
    std::vector<uint8_t> buf;
    uint8_t carry = 0;
    bool have_carry = false, done = false;
    while (file_pos < size && !done) {
      size_t n = (size_t)std::min<uint64_t>(block, size - file_pos);
      buf.resize((have_carry ? 1 : 0) + n);
      if (have_carry) buf[0] = carry;
      if (!read_at(base + file_pos, n, buf.data() + (have_carry ? 1 : 0)))
        return;
      uint64_t buf_base = file_pos - (have_carry ? 1 : 0);
      size_t i = 0;
      while (i + 1 < buf.size()) {
        if (buf[i] != 0xFF) {
          i++;
          continue;
        }
        uint8_t m = buf[i + 1];
        if (m >= 0xD0 && m <= 0xD7) {
          idx->spans.emplace_back(start, buf_base + i);
          start = buf_base + i + 2;
          i += 2;
        } else if (m == 0xD9) {
          idx->spans.emplace_back(start, buf_base + i);
          done = true;
          break;
        } else {
          i += (m == 0x00 || m == 0xFF) ? 1 : 2;
        }
      }
      if (!done) {
        have_carry = buf.back() == 0xFF;
        if (have_carry) carry = 0xFF;
        file_pos = buf_base + buf.size();
      }
    }
    if (!done) idx->spans.emplace_back(start, size);
    idx->ok = (int64_t)idx->spans.size() == idx->n_chunks;
  }

  // Chunk spans from the NDPI McuStarts tag (65426): strip-relative offset
  // of every restart chunk's first entropy byte, precomputed by the
  // scanner — O(chunks) index construction instead of a sequential scan
  // of the whole (multi-GB at level 0) entropy stream.  The convention is
  // validated against the header-derived grid (count, monotonicity, first
  // entry == entropy start, RST marker immediately before sampled
  // entries); mismatch returns false and the caller falls back to the
  // scan, so a deviating file stays correct.  Mirrors
  // _NdpiStripIndex._spans_from_mcu_starts in ../tiff_reader.py.
  bool spans_from_mcu_starts(const Page& p, NdpiIndex* idx) {
    const std::vector<uint64_t>& starts = p.mcu_starts;
    const uint64_t size = p.byte_counts[0];
    const uint64_t entropy_start = idx->headers.size();
    if ((int64_t)starts.size() != idx->n_chunks) return false;
    if (starts[0] != entropy_start) return false;
    // strictly increasing by >= 2 (each chunk ends with a 2-byte RST
    // marker); a smaller gap would invert the span arithmetic below.
    // Two conditions, not `< prev + 2`: prev + 2 can wrap uint64 on a
    // crafted tag and accept a non-monotonic sequence.
    for (size_t i = 1; i < starts.size(); i++)
      if (starts[i] <= starts[i - 1] ||
          starts[i] - starts[i - 1] < 2)
        return false;
    if (starts.back() >= size) return false;
    size_t probes[3] = {1, starts.size() / 2, starts.size() - 1};
    for (size_t j : probes) {
      if (j == 0 || j >= starts.size()) continue;
      uint8_t mk[2];
      if (!read_at(p.offsets[0] + starts[j] - 2, 2, mk)) return false;
      if (mk[0] != 0xFF || mk[1] < 0xD0 || mk[1] > 0xD7) return false;
    }
    idx->spans.clear();
    idx->spans.reserve(starts.size());
    for (size_t i = 0; i + 1 < starts.size(); i++)
      idx->spans.emplace_back(starts[i], starts[i + 1] - 2);
    uint8_t tail[2] = {0, 0};
    uint64_t last_end =
        (size >= 2 && read_at(p.offsets[0] + size - 2, 2, tail) &&
         tail[0] == 0xFF && tail[1] == 0xD9)
            ? size - 2
            : size;
    idx->spans.emplace_back(starts.back(), last_end);
    return true;
  }

  // Synthesize a standalone JPEG for one chunk (patched SOF dims, DRI=0,
  // chunk entropy bytes, EOI) and decode it.
  std::shared_ptr<std::vector<uint8_t>> decode_ndpi_chunk(
      const Page& p, const NdpiIndex& nd, int64_t index, int64_t cw,
      int64_t ch) {
    if (index < 0 || index >= (int64_t)nd.spans.size()) return nullptr;
    auto [s, e] = nd.spans[index];
    // inverted spans (possible from a corrupt McuStarts tag with gaps
    // < 2 bytes) would underflow e - s into a giant allocation
    if (e < s || e - s > file_size_) return nullptr;
    std::vector<uint8_t> jpeg(nd.headers.size() + (e - s) + 2);
    std::memcpy(jpeg.data(), nd.headers.data(), nd.headers.size());
    jpeg[nd.sof_off + 5] = (uint8_t)(ch >> 8);
    jpeg[nd.sof_off + 6] = (uint8_t)(ch & 0xFF);
    jpeg[nd.sof_off + 7] = (uint8_t)(cw >> 8);
    jpeg[nd.sof_off + 8] = (uint8_t)(cw & 0xFF);
    if (nd.dri_off >= 0) {
      jpeg[nd.dri_off + 4] = 0;
      jpeg[nd.dri_off + 5] = 0;
    }
    if (!read_at(p.offsets[0] + s, e - s, jpeg.data() + nd.headers.size()))
      return nullptr;
    jpeg[jpeg.size() - 2] = 0xFF;
    jpeg[jpeg.size() - 1] = 0xD9;
    auto out = std::make_shared<std::vector<uint8_t>>(cw * ch * 3);
    Page no_tables;  // chunk JPEG is self-contained
    if (!decode_jpeg(no_tables, jpeg, out->data(), cw, ch)) return nullptr;
    return out;
  }

  bool copy_raw(const Page& p, const std::vector<uint8_t>& data, uint8_t* out,
                int64_t cw, int64_t ch) {
    int spp = p.samples_per_pixel;
    // the generic branch reads 3 bytes at stride spp, so spp must be 1
    // or >= 3; a corrupt tag can also make the size check overflow
    if (spp != 1 && (spp < 3 || spp > 64)) return false;
    if ((int64_t)data.size() < cw * ch * spp) return false;
    if (spp == 3) {
      std::memcpy(out, data.data(), cw * ch * 3);
    } else if (spp == 1) {
      for (int64_t i = 0; i < cw * ch; i++)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = data[i];
    } else {
      for (int64_t i = 0; i < cw * ch; i++)
        std::memcpy(out + 3 * i, data.data() + spp * i, 3);
    }
    return true;
  }

  uint16_t rd16(const uint8_t* b) const {
    return little_ ? (b[0] | b[1] << 8) : (b[1] | b[0] << 8);
  }
  uint32_t rd32(const uint8_t* b) const {
    return little_ ? (uint32_t)b[0] | b[1] << 8 | b[2] << 16 |
                         (uint32_t)b[3] << 24
                   : (uint32_t)b[3] | b[2] << 8 | b[1] << 16 |
                         (uint32_t)b[0] << 24;
  }
  uint64_t rd64(const uint8_t* b) const {
    uint64_t lo = rd32(little_ ? b : b + 4);
    uint64_t hi = rd32(little_ ? b + 4 : b);
    return lo | (hi << 32);
  }

  std::vector<uint8_t> entry_data(const Entry& e) {
    // a corrupt count can demand a larger-than-file (or overflowing)
    // allocation; no real entry's payload can exceed the file itself
    if (e.count > file_size_) return {};
    size_t total = type_size(e.type) * e.count;
    if (!e.is_inline && total > file_size_) return {};
    std::vector<uint8_t> buf(total);
    if (e.is_inline) {
      std::memcpy(buf.data(), e.inline_value, total);
    } else {
      std::fseek(f_, (long)e.value_offset, SEEK_SET);
      if (std::fread(buf.data(), 1, total, f_) != total) buf.clear();
    }
    return buf;
  }

  std::vector<uint64_t> entry_ints(const Entry& e) {
    auto data = entry_data(e);
    std::vector<uint64_t> out;
    size_t ts = type_size(e.type);
    for (uint64_t i = 0; i < e.count && (i + 1) * ts <= data.size(); i++) {
      const uint8_t* b = data.data() + i * ts;
      switch (e.type) {
        case 1: out.push_back(b[0]); break;
        case 3: out.push_back(rd16(b)); break;
        case 4: out.push_back(rd32(b)); break;
        case 16: out.push_back(rd64(b)); break;
        default: out.push_back(0);
      }
    }
    return out;
  }

  double entry_rational(const Entry& e) {
    auto data = entry_data(e);
    if (data.size() < 8) return 0;
    uint32_t num = rd32(data.data());
    uint32_t den = rd32(data.data() + 4);
    return den ? double(num) / den : 0;
  }

  double entry_float(const Entry& e) {
    auto data = entry_data(e);
    if (e.type == 11 && data.size() >= 4) {
      uint32_t bits = rd32(data.data());
      float v;
      std::memcpy(&v, &bits, 4);
      return v;
    }
    if (e.type == 12 && data.size() >= 8) {
      uint64_t bits = rd64(data.data());
      double v;
      std::memcpy(&v, &bits, 8);
      return v;
    }
    auto ints = entry_ints(e);
    return ints.empty() ? 0 : (double)ints[0];
  }

  // Probe whether `off` points at a sane classic-TIFF IFD: entry count in
  // [1, 4096], tag ids sorted nondecreasing (the TIFF spec requires
  // sorted tags).  Disambiguates wrapped >4 GiB directory offsets.
  bool plausible_ifd(uint64_t off) {
    if (off + 2 > file_size_) return false;
    uint8_t hb[2];
    if (!read_at(off, 2, hb)) return false;
    uint16_t n = rd16(hb);
    if (n == 0 || n > 4096) return false;
    std::vector<uint8_t> raw((size_t)n * 12);
    if (!read_at(off + 2, raw.size(), raw.data())) return false;
    uint16_t prev_tag = 0;
    for (uint16_t i = 0; i < n; i++) {
      uint16_t t = rd16(raw.data() + (size_t)i * 12);
      if (t < prev_tag) return false;
      prev_tag = t;
    }
    return true;
  }

  // Directories appear in increasing file order: pick the smallest
  // raw + k*2^32 past prev_pos that probes as an IFD.  See open().
  uint64_t fix_chain_offset(uint64_t raw, uint64_t prev_pos) {
    if (raw == 0 || !needs_fix_) return raw;
    uint64_t cand = (prev_pos & ~0xFFFFFFFFull) | (raw & 0xFFFFFFFFull);
    if (cand <= prev_pos) cand += 1ull << 32;
    while (cand + 2 <= file_size_) {
      if (plausible_ifd(cand)) return cand;
      cand += 1ull << 32;
    }
    return raw;  // give up; let the caller fail loudly
  }

  // Data (payload / strip / tile) offsets: the scanner writes each
  // directory AFTER the data it points to, so the true offset is the
  // largest raw + k*2^32 not beyond the directory's own position.
  uint64_t fix_data_offset(uint64_t raw, uint64_t dir_pos) const {
    if (!needs_fix_) return raw;
    uint64_t cand = (dir_pos & ~0xFFFFFFFFull) | (raw & 0xFFFFFFFFull);
    if (cand > dir_pos) {
      if (cand < (1ull << 32)) return raw;
      cand -= 1ull << 32;
    }
    return cand;
  }

  bool parse_ifd(uint64_t offset, uint64_t* next) {
    std::fseek(f_, (long)offset, SEEK_SET);
    uint64_t n_entries;
    size_t entry_size = big_ ? 20 : 12;
    if (big_) {
      uint8_t b[8];
      if (std::fread(b, 1, 8, f_) != 8) return false;
      n_entries = rd64(b);
    } else {
      uint8_t b[2];
      if (std::fread(b, 1, 2, f_) != 2) return false;
      n_entries = rd16(b);
    }
    // classic TIFF caps at 65535 entries by format; a corrupt BigTIFF
    // count would otherwise size a multi-GB allocation.  A 0-entry
    // directory (spec-invalid but emitted by some writers) parses as an
    // empty page and drops in open()'s keep filter.
    if (n_entries > 65535) return false;
    std::vector<uint8_t> raw(n_entries * entry_size);
    if (std::fread(raw.data(), 1, raw.size(), f_) != raw.size()) return false;
    uint8_t nb[8];
    size_t next_size = big_ ? 8 : 4;
    if (std::fread(nb, 1, next_size, f_) != next_size) return false;
    *next = big_ ? rd64(nb) : rd32(nb);

    Page page;
    for (uint64_t i = 0; i < n_entries; i++) {
      const uint8_t* e = raw.data() + i * entry_size;
      uint16_t tag = rd16(e);
      Entry entry;
      entry.type = rd16(e + 2);
      entry.count = big_ ? rd64(e + 4) : rd32(e + 4);
      size_t total = type_size(entry.type) * entry.count;
      size_t inline_cap = big_ ? 8 : 4;
      const uint8_t* value = e + (big_ ? 12 : 8);
      entry.is_inline = total <= inline_cap;
      if (entry.is_inline) {
        std::memcpy(entry.inline_value, value, inline_cap);
      } else {
        entry.value_offset =
            fix_data_offset(big_ ? rd64(value) : rd32(value), offset);
      }
      switch (tag) {
        case TAG_IMAGE_WIDTH: page.width = first_int(entry); break;
        case TAG_IMAGE_LENGTH: page.height = first_int(entry); break;
        case TAG_COMPRESSION: page.compression = (int)first_int(entry);
          break;
        case TAG_SAMPLES_PER_PIXEL:
          page.samples_per_pixel = (int)first_int(entry); break;
        case TAG_ROWS_PER_STRIP:
          page.rows_per_strip = first_int(entry); break;
        case TAG_TILE_WIDTH: page.tile_width = first_int(entry); break;
        case TAG_TILE_LENGTH: page.tile_height = first_int(entry); break;
        case TAG_TILE_OFFSETS:
        case TAG_STRIP_OFFSETS:
          page.offsets = entry_ints(entry);
          for (auto& o : page.offsets) o = fix_data_offset(o, offset);
          break;
        case TAG_TILE_BYTE_COUNTS:
        case TAG_STRIP_BYTE_COUNTS:
          page.byte_counts = entry_ints(entry); break;
        case TAG_JPEG_TABLES: page.jpeg_tables = entry_data(entry); break;
        case TAG_X_RESOLUTION:
          page.x_resolution = entry_rational(entry); break;
        case TAG_Y_RESOLUTION:
          page.y_resolution = entry_rational(entry); break;
        case TAG_RESOLUTION_UNIT:
          page.resolution_unit = (int)first_int(entry); break;
        case TAG_NDPI_SOURCELENS:
          page.source_lens = entry_float(entry); break;
        case TAG_NDPI_MCU_STARTS:
          page.mcu_starts = entry_ints(entry); break;
        default: break;
      }
    }
    if (page.rows_per_strip == 0) page.rows_per_strip = page.height;
    // cap geometry at 16M px per side (far beyond any real slide): a
    // corrupt dimension would otherwise overflow area/grid arithmetic
    const int64_t kMaxDim = int64_t(1) << 24;
    if (page.width > kMaxDim || page.height > kMaxDim ||
        page.tile_width > kMaxDim || page.tile_height > kMaxDim ||
        page.rows_per_strip > kMaxDim ||
        page.width < 0 || page.height < 0 || page.tile_width < 0 ||
        page.tile_height < 0 || page.rows_per_strip < 0) {
      page.width = page.height = 0;  // drops in open()'s keep filter
    }
    pages_.push_back(std::move(page));
    return true;
  }

  uint64_t first_int(const Entry& e) {
    auto v = entry_ints(e);
    return v.empty() ? 0 : v[0];
  }

  FILE* f_ = nullptr;
  bool little_ = true, big_ = false;
  uint64_t file_size_ = 0;
  bool needs_fix_ = false;  // classic TIFF > 4 GiB: wrapped 32-bit offsets
  std::vector<Page> pages_;
  std::mutex file_mu_, cache_mu_, ndpi_mu_;
  std::map<std::pair<int, int64_t>, std::shared_ptr<std::vector<uint8_t>>>
      cache_;
  std::map<int, std::unique_ptr<NdpiIndex>> ndpi_;
  std::atomic<int64_t> chunk_decodes_{0};
};

}  // namespace

extern "C" {

void* gs_open(const char* path) {
  // never let an exception (e.g. bad_alloc on a corrupt size field)
  // cross the C ABI into the ctypes caller
  try {
    auto r = std::make_unique<Reader>();
    if (!r->open(path)) return nullptr;
    return r.release();
  } catch (...) {
    return nullptr;
  }
}

void gs_close(void* handle) { delete static_cast<Reader*>(handle); }

int gs_level_count(void* handle) {
  return static_cast<Reader*>(handle)->level_count();
}

void gs_level_dimensions(void* handle, int level, int64_t* w, int64_t* h) {
  Reader* r = static_cast<Reader*>(handle);
  if (level < 0 || level >= r->level_count()) {
    *w = *h = 0;
    return;
  }
  const Page& p = r->page(level);
  *w = p.width;
  *h = p.height;
}

// Total restart-chunk decodes since open (test instrumentation: window
// reads on single-strip JPEG levels must decode O(window), not O(slide)).
int64_t gs_chunk_decodes(void* handle) {
  return static_cast<Reader*>(handle)->chunk_decodes();
}

// How the level's restart-chunk index was (or would be) built:
// 0 = no virtual-tile index (tiled / multi-strip / non-JPEG level),
// 1 = entropy-stream marker scan, 2 = NDPI McuStarts tag (65426).
// Builds the index as a side effect.
int gs_ndpi_index_mode(void* handle, int level) {
  Reader* r = static_cast<Reader*>(handle);
  if (level < 0 || level >= r->level_count()) return 0;
  const NdpiIndex* nd =
      r->page(level).tiled() ? nullptr : r->ndpi_index(level);
  if (!nd) return 0;
  return nd->used_mcu_starts ? 2 : 1;
}

double gs_mpp_x(void* handle) { return static_cast<Reader*>(handle)->mpp(true); }
double gs_mpp_y(void* handle) { return static_cast<Reader*>(handle)->mpp(false); }
double gs_objective_power(void* handle) {
  return static_cast<Reader*>(handle)->objective();
}

// Read a region at `level`; (x, y) are LEVEL-0 coordinates (openslide
// convention).  Fills out (h * w * 3) RGB, white background out of bounds.
// Returns 0 on success.
int gs_read_region(void* handle, int level, int64_t x0_l0, int64_t y0_l0,
                   int64_t w, int64_t h, uint8_t* out) try {
  Reader* r = static_cast<Reader*>(handle);
  if (level < 0 || level >= r->level_count()) return -1;
  if (w < 0 || h < 0) return -1;
  if (w == 0 || h == 0) return 0;  // empty region: success, like the py reader
  const Page& p = r->page(level);
  const Page& base = r->page(0);
  double ds = double(base.width) / p.width;
  int64_t x0 = (int64_t)(x0_l0 / ds);
  int64_t y0 = (int64_t)(y0_l0 / ds);
  std::memset(out, 255, (size_t)(w * h * 3));

  int64_t ix0 = std::max<int64_t>(x0, 0), iy0 = std::max<int64_t>(y0, 0);
  int64_t ix1 = std::min<int64_t>(x0 + w, p.width);
  int64_t iy1 = std::min<int64_t>(y0 + h, p.height);
  if (ix1 <= ix0 || iy1 <= iy0) return 0;

  struct Job {
    int64_t index, tx, ty;
  };
  std::vector<Job> jobs;
  // build (once) the restart-marker virtual-tile index on this thread
  // before fanning decode jobs out
  const NdpiIndex* nd = p.tiled() ? nullptr : r->ndpi_index(level);
  int64_t grid_tw = 0, grid_th = 0;
  if (nd) {
    grid_tw = nd->tile_w;
    grid_th = nd->tile_h;
  } else if (p.tiled()) {
    grid_tw = p.tile_width;
    grid_th = p.tile_height;
  }
  if (grid_tw > 0) {
    if (grid_th <= 0) return -1;  // corrupt TileLength: avoid div-by-zero
    int64_t across = nd ? nd->tiles_across : (p.width + grid_tw - 1) / grid_tw;
    for (int64_t ty = iy0 / grid_th; ty <= (iy1 - 1) / grid_th; ty++)
      for (int64_t tx = ix0 / grid_tw; tx <= (ix1 - 1) / grid_tw; tx++)
        jobs.push_back({ty * across + tx, tx, ty});
  } else {
    if (p.rows_per_strip <= 0) return -1;  // corrupt RowsPerStrip
    for (int64_t s = iy0 / p.rows_per_strip; s <= (iy1 - 1) / p.rows_per_strip;
         s++)
      jobs.push_back({s, 0, s});
  }

  std::mutex err_mu;
  bool failed = false;
  // an exception escaping a std::thread terminates the process, so the
  // worker converts any throw (e.g. bad_alloc) into a failed read
  auto work = [&](size_t begin, size_t end) {
    try {
    for (size_t j = begin; j < end; j++) {
      const Job& job = jobs[j];
      int64_t cw, chh;
      auto tile = r->chunk(level, job.index, &cw, &chh);
      if (!tile) {
        std::lock_guard<std::mutex> lock(err_mu);
        failed = true;
        return;
      }
      int64_t ox = grid_tw > 0 ? job.tx * grid_tw : 0;
      int64_t oy = grid_tw > 0 ? job.ty * grid_th : job.ty * p.rows_per_strip;
      int64_t sx0 = std::max(ix0, ox), sy0 = std::max(iy0, oy);
      int64_t sx1 = std::min(ix1, ox + cw), sy1 = std::min(iy1, oy + chh);
      for (int64_t y = sy0; y < sy1; y++) {
        std::memcpy(out + ((y - y0) * w + (sx0 - x0)) * 3,
                    tile->data() + ((y - oy) * cw + (sx0 - ox)) * 3,
                    (size_t)(sx1 - sx0) * 3);
      }
    }
    } catch (...) {
      std::lock_guard<std::mutex> lock(err_mu);
      failed = true;
    }
  };

  size_t n_threads = std::min<size_t>(jobs.size(),
                                      std::thread::hardware_concurrency());
  if (n_threads <= 1) {
    work(0, jobs.size());
  } else {
    std::vector<std::thread> threads;
    size_t per = (jobs.size() + n_threads - 1) / n_threads;
    try {
      for (size_t t = 0; t < n_threads; t++) {
        size_t begin = t * per;
        size_t end = std::min(jobs.size(), begin + per);
        if (begin < end) threads.emplace_back(work, begin, end);
      }
    } catch (...) {
      // thread spawn failed (e.g. EAGAIN): join what was started —
      // destroying a joinable std::thread would std::terminate
      for (auto& t : threads) t.join();
      throw;  // -> the function-level catch returns -3
    }
    for (auto& t : threads) t.join();
  }
  return failed ? -2 : 0;
} catch (...) {
  return -3;  // exception (e.g. bad_alloc) must not cross the C ABI
}

}  // extern "C"
