// Native host-side components of the string-matching framework.
//
// The OpenCL reference keeps its serial baselines, table precompute and text
// loading in C on the host (SURVEY.md components R6, R8-R10, R11); this
// library is their native equivalent here.  The device compute path is
// JAX/XLA — this code never touches the accelerator; it provides:
//
//   * serial CPU baselines of all four algorithms (correctness oracle +
//     speedup denominator, SURVEY.md R6)
//   * table precompute: KMP failure function + dense DFA, Boyer-Moore
//     bad-character / good-suffix, Rabin-Karp power vector (R8-R10)
//   * fast seeded corpus generation (R13) — xoshiro256** based
//   * mmap-backed chunked file reads with sequential readahead (R11)
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// Serial baselines (R6).  Each returns the number of matches and fills
// out_offsets (int64) up to cap entries with 0-based start offsets,
// overlapping occurrences included — the framework-wide output contract.
// ---------------------------------------------------------------------------

int64_t tm_serial_naive(const uint8_t* text, int64_t n, const uint8_t* pat,
                        int64_t m, int64_t* out_offsets, int64_t cap) {
  if (m <= 0 || n < m) return 0;
  int64_t count = 0;
  for (int64_t i = 0; i + m <= n; ++i) {
    if (memcmp(text + i, pat, (size_t)m) == 0) {
      if (count < cap) out_offsets[count] = i;
      ++count;
    }
  }
  return count;
}

void tm_kmp_failure(const uint8_t* pat, int64_t m, int32_t* fail) {
  // fail[j] = length of the longest proper prefix of pat[0..j] that is also
  // a suffix (classic prefix function).
  fail[0] = 0;
  int32_t k = 0;
  for (int64_t j = 1; j < m; ++j) {
    while (k > 0 && pat[j] != pat[k]) k = fail[k - 1];
    if (pat[j] == pat[k]) ++k;
    fail[j] = k;
  }
}

int64_t tm_serial_kmp(const uint8_t* text, int64_t n, const uint8_t* pat,
                      int64_t m, int64_t* out_offsets, int64_t cap) {
  if (m <= 0 || n < m) return 0;
  std::vector<int32_t> fail(m);
  tm_kmp_failure(pat, m, fail.data());
  int64_t count = 0;
  int32_t k = 0;
  for (int64_t i = 0; i < n; ++i) {
    while (k > 0 && text[i] != pat[k]) k = fail[k - 1];
    if (text[i] == pat[k]) ++k;
    if (k == m) {
      int64_t s = i - m + 1;
      if (count < cap) out_offsets[count] = s;
      ++count;
      k = fail[k - 1];
    }
  }
  return count;
}

void tm_bm_bad_char(const uint8_t* pat, int64_t m, int32_t* bc /*256*/) {
  for (int i = 0; i < 256; ++i) bc[i] = -1;
  for (int64_t j = 0; j < m; ++j) bc[pat[j]] = (int32_t)j;
}

// good_suffix[j+1] = shift on mismatch at pattern index j (after matching
// suffix pat[j+1..m)); good_suffix[0] = shift after a full match.  Matches
// ops/tables.bm_good_suffix layout.
void tm_bm_good_suffix(const uint8_t* pat, int64_t m, int32_t* gs /*m+1*/) {
  std::vector<int32_t> shift(m + 1, 0);
  std::vector<int32_t> border(m + 1, 0);
  int64_t i = m, j = m + 1;
  border[i] = (int32_t)j;
  while (i > 0) {
    while (j <= m && pat[i - 1] != pat[j - 1]) {
      if (shift[j] == 0) shift[j] = (int32_t)(j - i);
      j = border[j];
    }
    --i; --j;
    border[i] = (int32_t)j;
  }
  j = border[0];
  for (i = 0; i <= m; ++i) {
    if (shift[i] == 0) shift[i] = (int32_t)j;
    if (i == j) j = border[j];
  }
  // Reindex: standard `shift[]` is indexed by mismatch position + 1.
  // gs[0] (full match) = shift[0]; gs[jj+1] (mismatch at jj) = shift[jj+1].
  for (i = 0; i <= m; ++i) gs[i] = shift[i];
}

int64_t tm_serial_bm(const uint8_t* text, int64_t n, const uint8_t* pat,
                     int64_t m, int64_t* out_offsets, int64_t cap) {
  if (m <= 0 || n < m) return 0;
  int32_t bc[256];
  tm_bm_bad_char(pat, m, bc);
  std::vector<int32_t> gs(m + 1);
  tm_bm_good_suffix(pat, m, gs.data());
  int64_t count = 0, s = 0;
  while (s + m <= n) {
    int64_t j = m - 1;
    while (j >= 0 && pat[j] == text[s + j]) --j;
    if (j < 0) {
      if (count < cap) out_offsets[count] = s;
      ++count;
      s += gs[0];
    } else {
      int64_t bcs = j - bc[text[s + j]];
      int64_t gss = gs[j + 1];
      s += (bcs > gss ? bcs : gss) > 0 ? (bcs > gss ? bcs : gss) : 1;
    }
  }
  return count;
}

void tm_rk_powers(int64_t m, uint32_t base, uint32_t* powers /*m*/) {
  // powers[j] = base^(m-1-j) mod 2^32 (wrapping), matching ops/tables.
  uint32_t p = 1;
  for (int64_t j = m - 1; j >= 0; --j) {
    powers[j] = p;
    p *= base;
  }
}

int64_t tm_serial_rk(const uint8_t* text, int64_t n, const uint8_t* pat,
                     int64_t m, uint32_t base, int64_t* out_offsets,
                     int64_t cap) {
  if (m <= 0 || n < m) return 0;
  std::vector<uint32_t> powers(m);
  tm_rk_powers(m, base, powers.data());
  uint32_t target = 0, h = 0;
  for (int64_t j = 0; j < m; ++j) {
    target += (uint32_t)pat[j] * powers[j];
    h += (uint32_t)text[j] * powers[j];
  }
  const uint32_t bpow = powers[0];  // base^(m-1)
  int64_t count = 0;
  for (int64_t i = 0;; ++i) {
    if (h == target && memcmp(text + i, pat, (size_t)m) == 0) {
      if (count < cap) out_offsets[count] = i;
      ++count;
    }
    if (i + m >= n) break;
    // roll: remove text[i]*base^(m-1), shift, add text[i+m]
    h = (h - (uint32_t)text[i] * bpow) * base + (uint32_t)text[i + m];
  }
  return count;
}

// ---------------------------------------------------------------------------
// Seeded corpus generation (R13) — xoshiro256**; deterministic per seed.
// NOTE: streams differ from numpy's PCG64 — these are the native corpora,
// used when generation speed matters (multi-GB benches).
// ---------------------------------------------------------------------------

static inline uint64_t rotl64(uint64_t x, int k) {
  return (x << k) | (x >> (64 - k));
}

struct Xoshiro {
  uint64_t s[4];
  explicit Xoshiro(uint64_t seed) {
    // splitmix64 init
    uint64_t z = seed + 0x9e3779b97f4a7c15ULL;
    for (int i = 0; i < 4; ++i) {
      z += 0x9e3779b97f4a7c15ULL;
      uint64_t t = z;
      t = (t ^ (t >> 30)) * 0xbf58476d1ce4e5b9ULL;
      t = (t ^ (t >> 27)) * 0x94d049bb133111ebULL;
      s[i] = t ^ (t >> 31);
    }
  }
  inline uint64_t next() {
    uint64_t result = rotl64(s[1] * 5, 7) * 9;
    uint64_t t = s[1] << 17;
    s[2] ^= s[0]; s[3] ^= s[1]; s[1] ^= s[2]; s[0] ^= s[3]; s[2] ^= t;
    s[3] = rotl64(s[3], 45);
    return result;
  }
};

void tm_gen_bytes(uint64_t seed, uint8_t* dst, int64_t n) {
  Xoshiro rng(seed);
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t v = rng.next();
    memcpy(dst + i, &v, 8);
  }
  if (i < n) {
    uint64_t v = rng.next();
    memcpy(dst + i, &v, (size_t)(n - i));
  }
}

void tm_gen_alphabet(uint64_t seed, const uint8_t* alphabet, int32_t k,
                     uint8_t* dst, int64_t n) {
  Xoshiro rng(seed);
  // rejection-free: multiply-shift mapping of 8-bit draws onto [0, k)
  int64_t i = 0;
  while (i < n) {
    uint64_t v = rng.next();
    for (int b = 0; b < 8 && i < n; ++b, v >>= 8) {
      dst[i++] = alphabet[(uint32_t)((v & 0xFF) * k) >> 8];
    }
  }
}

// ---------------------------------------------------------------------------
// mmap chunk reader (R11): sequential-readahead file access for the
// streaming driver.  Handles are plain malloc'd structs.
// ---------------------------------------------------------------------------

struct TmFile {
  int fd;
  int64_t size;
  const uint8_t* map;
};

void* tm_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* map = nullptr;
  if (st.st_size > 0) {
    map = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (map == MAP_FAILED) { close(fd); return nullptr; }
    madvise(map, (size_t)st.st_size, MADV_SEQUENTIAL);
  }
  TmFile* f = (TmFile*)malloc(sizeof(TmFile));
  f->fd = fd;
  f->size = st.st_size;
  f->map = (const uint8_t*)map;
  return f;
}

int64_t tm_size(void* handle) { return ((TmFile*)handle)->size; }

// Copy [offset, offset+len) into dst (zero-fill past EOF); returns bytes
// actually read from the file.  Issues WILLNEED readahead for the next
// window so the copy of chunk k overlaps the page-in of chunk k+1.
int64_t tm_read_chunk(void* handle, int64_t offset, int64_t len, uint8_t* dst) {
  TmFile* f = (TmFile*)handle;
  if (offset >= f->size || len <= 0) {
    if (len > 0) memset(dst, 0, (size_t)len);
    return 0;
  }
  int64_t avail = f->size - offset;
  int64_t take = len < avail ? len : avail;
  int64_t ra_end = offset + 2 * len < f->size ? offset + 2 * len : f->size;
  if (ra_end > offset + take)
    madvise((void*)(f->map + offset + take), (size_t)(ra_end - offset - take),
            MADV_WILLNEED);
  memcpy(dst, f->map + offset, (size_t)take);
  if (take < len) memset(dst + take, 0, (size_t)(len - take));
  return take;
}

void tm_close(void* handle) {
  TmFile* f = (TmFile*)handle;
  if (f->map) munmap((void*)f->map, (size_t)f->size);
  close(f->fd);
  free(f);
}

}  // extern "C"
