// kektor_native: the port's host runtime, a copy of the JAX package's
// kektordb_tpu/native/kektor_native.cpp with the same C ABI and entry
// names, built by g++ and bound with ctypes (kektordb_tpu_torch/host_native.py).
//
//   * f32 L2 / dot / cosine and int8 dot batch distances, and an exact
//     top-k: the host's exact search (bruteforce_topk)
//   * slice-by-8 CRC32 (zlib-compatible) and the journal frame scanner
//     that the port's replay runs (persist/aof.read_frames)
//   * the "KTNA" arena spill file: a 64-byte header, then f32 rows
//   * a base64 decoder (the port's own entry, not in the JAX package's
//     library): the batched search's `query_vectors_b64`, decoded straight
//     from the request body (server/http.py)
//
// The frame scanner differs from the JAX package's in two ways: it takes a
// start offset and an output capacity and says where it stopped, so the
// caller resumes until the buffer ends (the JAX package's stops for good
// at its capacity and drops the rest of the journal); and it reports the
// offset of every corrupt region, a torn tail shorter than a frame header
// included, as the Python scanner (persist/aof.scan_frames) does.
//
// It is built without -march: the library is the same on every x86-64
// host, so one built on one machine never meets an instruction another
// lacks. `omp simd` needs only -fopenmp-simd (no OpenMP runtime).

#include <sys/types.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// distances
// ---------------------------------------------------------------------------

// Squared L2 between one query and n rows. out[n].
void kn_l2_batch(const float* q, const float* rows, int64_t n, int64_t d,
                 float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* r = rows + i * d;
    float acc = 0.f;
#pragma omp simd reduction(+ : acc)
    for (int64_t j = 0; j < d; ++j) {
      float t = q[j] - r[j];
      acc += t * t;
    }
    out[i] = acc;
  }
}

void kn_dot_batch(const float* q, const float* rows, int64_t n, int64_t d,
                  float* out) {
  for (int64_t i = 0; i < n; ++i) {
    const float* r = rows + i * d;
    float acc = 0.f;
#pragma omp simd reduction(+ : acc)
    for (int64_t j = 0; j < d; ++j) acc += q[j] * r[j];
    out[i] = acc;
  }
}

// cosine distance on pre-normalized vectors: 1 - dot.
void kn_cosine_batch(const float* q, const float* rows, int64_t n, int64_t d,
                     float* out) {
  kn_dot_batch(q, rows, n, d, out);
  for (int64_t i = 0; i < n; ++i) out[i] = 1.f - out[i];
}

// int8 dot with int32 accumulation.
void kn_dot_i8_batch(const int8_t* q, const int8_t* rows, int64_t n,
                     int64_t d, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const int8_t* r = rows + i * d;
    int32_t acc = 0;
#pragma omp simd reduction(+ : acc)
    for (int64_t j = 0; j < d; ++j)
      acc += static_cast<int32_t>(q[j]) * static_cast<int32_t>(r[j]);
    out[i] = acc;
  }
}

// Exact top-k, ascending by (distance, row): a max-heap of the best k whose
// strict `<` keeps the lower row of two equal distances. idx_out / dist_out
// have k slots; slots past n hold row -1 at +inf.
void kn_topk(const float* dists, int64_t n, int64_t k, int32_t* idx_out,
             float* dist_out) {
  using P = std::pair<float, int32_t>;
  std::priority_queue<P> heap;
  for (int64_t i = 0; i < n; ++i) {
    if ((int64_t)heap.size() < k) {
      heap.emplace(dists[i], (int32_t)i);
    } else if (k > 0 && dists[i] < heap.top().first) {
      heap.pop();
      heap.emplace(dists[i], (int32_t)i);
    }
  }
  int64_t m = (int64_t)heap.size();
  for (int64_t i = m - 1; i >= 0; --i) {
    dist_out[i] = heap.top().first;
    idx_out[i] = heap.top().second;
    heap.pop();
  }
  for (int64_t i = m; i < k; ++i) {
    dist_out[i] = __builtin_inff();
    idx_out[i] = -1;
  }
}

// Brute-force search: queries [b, d] x rows [n, d] -> per-query top-k.
// metric 0: squared L2; 1: cosine (1 - dot of normalized vectors).
void kn_bruteforce_topk(const float* queries, int64_t b, const float* rows,
                        int64_t n, int64_t d, int64_t k, int metric,
                        int32_t* idx_out, float* dist_out) {
  std::vector<float> scratch(n);
  for (int64_t qi = 0; qi < b; ++qi) {
    const float* q = queries + qi * d;
    if (metric == 0)
      kn_l2_batch(q, rows, n, d, scratch.data());
    else
      kn_cosine_batch(q, rows, n, d, scratch.data());
    kn_topk(scratch.data(), n, k, idx_out + qi * k, dist_out + qi * k);
  }
}

// ---------------------------------------------------------------------------
// CRC32 (IEEE, zlib-compatible), slice-by-8
// ---------------------------------------------------------------------------

static uint32_t crc_table[8][256];
static std::atomic<bool> crc_ready{false};

static void crc_init() {
  static std::atomic<bool> building{false};
  if (crc_ready.load(std::memory_order_acquire)) return;
  if (building.exchange(true)) {
    while (!crc_ready.load(std::memory_order_acquire)) {}
    return;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int j = 0; j < 8; ++j) c = (c >> 1) ^ (0xEDB88320u & (-(c & 1u)));
    crc_table[0][i] = c;
  }
  for (int t = 1; t < 8; ++t)
    for (uint32_t i = 0; i < 256; ++i)
      crc_table[t][i] =
          (crc_table[t - 1][i] >> 8) ^ crc_table[0][crc_table[t - 1][i] & 0xFF];
  crc_ready.store(true, std::memory_order_release);
}

uint32_t kn_crc32(const uint8_t* data, int64_t len, uint32_t seed) {
  crc_init();
  uint32_t c = ~seed;
  while (len >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= c;
    c = crc_table[7][lo & 0xFF] ^ crc_table[6][(lo >> 8) & 0xFF] ^
        crc_table[5][(lo >> 16) & 0xFF] ^ crc_table[4][lo >> 24] ^
        crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF] ^
        crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len-- > 0) c = (c >> 8) ^ crc_table[0][(c ^ *data++) & 0xFF];
  return ~c;
}

// ---------------------------------------------------------------------------
// journal frames: [A5][op u8][len u32][crc32 u32][payload], little-endian
// ---------------------------------------------------------------------------

static const uint8_t KN_MAGIC = 0xA5;
static const uint32_t KN_MAX_PAYLOAD = 1u << 30;
static const int64_t KN_HDR = 10;

// Whether a whole frame with a valid CRC starts at pos (persist/aof.py's
// decode_frame without an exception).
static bool frame_at(const uint8_t* buf, int64_t len, int64_t pos,
                     uint32_t* plen_out) {
  if (pos + KN_HDR > len || buf[pos] != KN_MAGIC) return false;
  uint32_t plen, crc;
  std::memcpy(&plen, buf + pos + 2, 4);
  std::memcpy(&crc, buf + pos + 6, 4);
  if (plen > KN_MAX_PAYLOAD || pos + KN_HDR + (int64_t)plen > len)
    return false;
  if (kn_crc32(buf + pos + KN_HDR, plen, 0) != crc) return false;
  *plen_out = plen;
  return true;
}

// Scans buf[start:len): for every valid frame writes its payload offset,
// payload length and opcode; for every corrupt region, the offset where it
// begins (a torn tail shorter than a header is one). After a corrupt
// region the scan resumes at the next magic byte that starts a valid
// frame; with none left it ends. Stops before a frame or region that would
// overflow `cap` entries of either output, so the caller resumes at *stop
// and finds every frame of the buffer, each once; *stop == len when the
// buffer is done. Returns the frames written; *n_corrupt gets the regions.
int64_t kn_scan_frames(const uint8_t* buf, int64_t len, int64_t start,
                       int64_t cap, int64_t* offsets, int64_t* lengths,
                       uint8_t* opcodes, int64_t* corrupt,
                       int64_t* n_corrupt, int64_t* stop) {
  crc_init();
  int64_t pos = start, found = 0, bad = 0;
  while (pos < len && found < cap && bad < cap) {
    uint32_t plen;
    if (frame_at(buf, len, pos, &plen)) {
      offsets[found] = pos + KN_HDR;
      lengths[found] = plen;
      opcodes[found] = buf[pos + 1];
      ++found;
      pos += KN_HDR + plen;
      continue;
    }
    corrupt[bad++] = pos;
    int64_t next = len;
    for (int64_t scan = pos + 1; scan < len; ++scan) {
      const void* hit = std::memchr(buf + scan, KN_MAGIC, len - scan);
      if (!hit) break;
      scan = (const uint8_t*)hit - buf;
      if (frame_at(buf, len, scan, &plen)) {
        next = scan;
        break;
      }
    }
    pos = next;
  }
  *n_corrupt = bad;
  *stop = pos < len ? pos : len;
  return found;
}

// ---------------------------------------------------------------------------
// arena spill files: header u32[16] = magic "KTNA", version 1, dim,
// precision 0 (f32), rows as i64 in words 4-5; then rows x dim f32
// ---------------------------------------------------------------------------

static const uint32_t ARENA_MAGIC = 0x4B544E41;

int kn_arena_write(const char* path, const float* data, int64_t rows,
                   int64_t dim) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint32_t header[16] = {0};
  header[0] = ARENA_MAGIC;
  header[1] = 1;
  header[2] = (uint32_t)dim;
  header[3] = 0;
  std::memcpy(header + 4, &rows, 8);
  if (std::fwrite(header, sizeof(header), 1, f) != 1) {
    std::fclose(f);
    return -2;
  }
  size_t n = (size_t)rows * (size_t)dim;
  size_t wrote = n ? std::fwrite(data, sizeof(float), n, f) : 0;
  int closed = std::fclose(f);
  return wrote == n && closed == 0 ? 0 : -3;
}

// Reads rows [row_start, row_start + count) into out; with count 0 it
// reads only the header's dim and rows. Returns 0, or -1 (no file), -2
// (short header or bad magic), -3 (rows beyond the file's), -4 (short
// read).
int kn_arena_read(const char* path, int64_t row_start, int64_t count,
                  float* out, int64_t* dim_out, int64_t* rows_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  uint32_t header[16];
  if (std::fread(header, sizeof(header), 1, f) != 1 ||
      header[0] != ARENA_MAGIC) {
    std::fclose(f);
    return -2;
  }
  int64_t dim = header[2], rows;
  std::memcpy(&rows, header + 4, 8);
  if (dim_out) *dim_out = dim;
  if (rows_out) *rows_out = rows;
  if (count > 0) {
    if (row_start < 0 || row_start + count > rows) {
      std::fclose(f);
      return -3;
    }
    off_t at = (off_t)sizeof(header) + (off_t)row_start * dim * 4;
    size_t n = (size_t)count * (size_t)dim;
    if (fseeko(f, at, SEEK_SET) != 0 ||
        std::fread(out, sizeof(float), n, f) != n) {
      std::fclose(f);
      return -4;
    }
  }
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// base64: the standard alphabet (A-Z a-z 0-9 + /), a length that is a
// multiple of 4, '=' only as the last one or two characters
// ---------------------------------------------------------------------------

// b64_d[j][c]: character c at position j of a quad, shifted to where its six
// bits land in the quad's three bytes read as a little-endian u32; a byte
// outside the alphabet sets bit 24, so one test of the OR of a quad's four
// entries refuses it.
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "the base64 tables assume a little-endian host");
static const uint32_t B64_BAD = 0x01FFFFFFu;
static uint32_t b64_d[4][256];
static std::atomic<bool> b64_ready{false};

static void b64_init() {
  static std::atomic<bool> building{false};
  if (b64_ready.load(std::memory_order_acquire)) return;
  if (building.exchange(true)) {
    while (!b64_ready.load(std::memory_order_acquire)) {}
    return;
  }
  static const char abc[] =
      "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
  for (int j = 0; j < 4; ++j)
    for (int c = 0; c < 256; ++c) b64_d[j][c] = B64_BAD;
  for (uint32_t v = 0; v < 64; ++v) {
    uint8_t c = (uint8_t)abc[v];
    b64_d[0][c] = v << 2;
    b64_d[1][c] = (v >> 4) | ((v & 0xF) << 12);
    b64_d[2][c] = ((v >> 2) << 8) | ((v & 0x3) << 22);
    b64_d[3][c] = v << 16;
  }
  b64_ready.store(true, std::memory_order_release);
}

// Decodes src[0:n) into out, which holds n / 4 * 3 bytes. Returns the bytes
// decoded, or -1 where src is not such a span: a byte outside the alphabet
// (a backslash, a quote, a newline, the URL-safe '-' and '_' included), '='
// anywhere but the last one or two places, or n not a multiple of 4. The
// bits a padded quad leaves over are ignored, as Python's base64 does.
int64_t kn_b64_decode(const uint8_t* src, int64_t n, uint8_t* out) {
  b64_init();
  if (n < 0 || n % 4) return -1;
  if (n == 0) return 0;
  const int64_t quads = n / 4;
  uint32_t bad = 0;
  // every quad but the last stores four bytes, the fourth overwritten by
  // the next quad's first
  for (int64_t i = 0; i + 1 < quads; ++i) {
    const uint8_t* s = src + 4 * i;
    uint32_t x = b64_d[0][s[0]] | b64_d[1][s[1]] | b64_d[2][s[2]] |
                 b64_d[3][s[3]];
    bad |= x;
    std::memcpy(out + 3 * i, &x, 4);
  }
  if (bad & 0xFF000000u) return -1;
  const uint8_t* s = src + 4 * (quads - 1);
  uint8_t* o = out + 3 * (quads - 1);
  int pads = s[3] != '=' ? 0 : s[2] != '=' ? 1 : 2;
  uint32_t x = b64_d[0][s[0]] | b64_d[1][s[1]] |
               (pads < 2 ? b64_d[2][s[2]] : 0) |
               (pads < 1 ? b64_d[3][s[3]] : 0);
  if (x & 0xFF000000u) return -1;
  for (int j = 0; j < 3 - pads; ++j) o[j] = (uint8_t)(x >> (8 * j));
  return 3 * quads - pads;
}

}  // extern "C"
