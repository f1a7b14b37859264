// Native yx/libsvm parser — the host-side hot path of the input pipeline.
//
// The reference's data layer is Python text parsing over a fully-in-RAM
// dataset (SURVEY.md §1, C3). At TPU speeds host parsing is the projected
// bottleneck (SURVEY.md §3.5c), so this is a single-pass, allocation-free
// C++ scanner: bytes in, packed (labels, int32[B,S] global-id slots) out,
// with per-field slot routing identical to deepctr_tpu.data.parser.pack_ids.
//
// Exposed via ctypes (no pybind11 in this image); built on demand by
// deepctr_tpu/data/native/__init__.py.

#include <cstdint>
#include <cstring>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

// Field index of a global id via branchless-ish linear/binary search over
// cumulative vocab bounds. num_fields is small (~16) so linear scan wins.
inline int32_t field_of(int64_t gid, const int64_t* bounds, int32_t nf) {
  for (int32_t f = 0; f < nf; ++f) {
    if (gid < bounds[f]) return f;
  }
  return nf;  // out of range
}

}  // namespace

extern "C" {

// Count newline-terminated non-empty rows (for output allocation).
int64_t yx_count_rows(const char* buf, int64_t len) {
  int64_t rows = 0;
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* q = skip_ws(p, line_end);
    if (q < line_end) ++rows;
    p = nl ? nl + 1 : end;
  }
  return rows;
}

// Parse yx text into labels + packed per-field id slots.
//   field_bounds: int64[num_fields] cumulative vocab sizes (exclusive upper
//                 bounds of each field's global-id range).
//   slot_offsets: int32[num_fields] first packed slot per field.
//   max_lens:     int32[num_fields] slots per field.
// ids_out must be pre-filled by the CALLER?  No: this function fills padding
// itself. Overflowing ids (beyond a field's max_len) and out-of-vocab ids are
// dropped, matching pack_ids(strict=False).
// Returns rows written, or -1 if max_rows would be exceeded.
int64_t yx_parse(const char* buf, int64_t len, const int64_t* field_bounds,
                 int32_t num_fields, const int32_t* slot_offsets,
                 const int32_t* max_lens, int32_t num_slots, int32_t pad_id,
                 float* labels_out, int32_t* ids_out, int64_t max_rows) {
  int64_t row = 0;
  const char* p = buf;
  const char* end = buf + len;
  // cursor[f] = ids already packed for field f on the current row
  int32_t cursor[256];
  if (num_fields > 256) return -2;

  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    const char* q = skip_ws(p, line_end);
    if (q >= line_end) {  // blank line
      p = nl ? nl + 1 : end;
      continue;
    }
    if (row >= max_rows) return -1;

    // label: integer or float before first space
    bool neg = false;
    if (*q == '-') { neg = true; ++q; }
    double label = 0.0;
    while (q < line_end && *q >= '0' && *q <= '9') {
      label = label * 10.0 + (*q - '0');
      ++q;
    }
    if (q < line_end && *q == '.') {  // fractional labels tolerated
      ++q;
      double scale = 0.1;
      while (q < line_end && *q >= '0' && *q <= '9') {
        label += (*q - '0') * scale;
        scale *= 0.1;
        ++q;
      }
    }
    labels_out[row] = static_cast<float>(neg ? -label : label);

    int32_t* ids_row = ids_out + row * num_slots;
    for (int32_t s = 0; s < num_slots; ++s) ids_row[s] = pad_id;
    for (int32_t f = 0; f < num_fields; ++f) cursor[f] = 0;

    const int64_t vocab = field_bounds[num_fields - 1];
    // ids within a yx line are ascending in practice (featindex order), so
    // the field lookup advances a cursor monotonically — O(1)/token instead
    // of a linear scan over the bounds; out-of-order ids just reset it.
    int32_t f_hint = 0;
    while (q < line_end) {
      q = skip_ws(q, line_end);
      if (q >= line_end) break;
      // token: <gid>[:val]
      int64_t gid = 0;
      bool any = false;
      while (q < line_end && *q >= '0' && *q <= '9') {
        gid = gid * 10 + (*q - '0');
        ++q;
        any = true;
      }
      // skip ":val" (value always 1 in the reference format)
      while (q < line_end && *q != ' ' && *q != '\t') ++q;
      if (!any || gid >= vocab) continue;
      if (f_hint > 0 && gid < field_bounds[f_hint - 1]) f_hint = 0;
      while (f_hint < num_fields && gid >= field_bounds[f_hint]) ++f_hint;
      int32_t f = f_hint;
      if (f >= num_fields) continue;
      int32_t k = cursor[f];
      if (k >= max_lens[f]) continue;
      ids_row[slot_offsets[f] + k] = static_cast<int32_t>(gid);
      cursor[f] = k + 1;
    }
    ++row;
    p = nl ? nl + 1 : end;
  }
  return row;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Criteo raw TSV: label \t I1..I13 \t C1..C26 (blanks allowed).
// Must match deepctr_tpu/data/criteo.py exactly: integer features get
// floor(log(x+1)^2)+3 buckets (0=missing, 1=malformed, 2=negative),
// categoricals get FNV-1a 64 % cat_buckets, missing -> bucket 0.
// ---------------------------------------------------------------------------

#include <cmath>

namespace {

constexpr int kNumInt = 13;
constexpr int kNumCat = 26;
constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnvPrime = 0x100000001B3ULL;

inline uint64_t fnv1a64(const char* p, int64_t len) {
  uint64_t h = kFnvOffset;
  for (int64_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(p[i]);
    h *= kFnvPrime;
  }
  return h;
}

inline int32_t int_bucket(const char* p, int64_t len, int32_t max_buckets) {
  if (len == 0) return 0;
  bool neg = false;
  int64_t i = 0;
  if (p[0] == '-') { neg = true; i = 1; }
  long long v = 0;
  for (; i < len; ++i) {
    if (p[i] < '0' || p[i] > '9') return 1;  // malformed
    v = v * 10 + (p[i] - '0');
    if (v > (1LL << 40)) break;  // clamp; bucket saturates anyway
  }
  if (neg) return 2;
  double lg = std::log(static_cast<double>(v) + 1.0);
  int32_t b = static_cast<int32_t>(std::floor(lg * lg)) + 3;
  return b < max_buckets ? b : max_buckets - 1;
}

}  // namespace

extern "C" {

// Parse Criteo TSV into packed per-field global ids.
//   offsets: int64[39] global id offset per field (13 int + 26 cat).
//   int_buckets / cat_buckets: per-column vocab sizes.
// Returns rows written, or -1 on overflow of max_rows.
int64_t criteo_parse(const char* buf, int64_t len, const int64_t* offsets,
                     int32_t int_buckets, int64_t cat_buckets,
                     float* labels_out, int32_t* ids_out, int64_t max_rows) {
  int64_t row = 0;
  const char* p = buf;
  const char* end = buf + len;
  const int32_t num_fields = kNumInt + kNumCat;

  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    // tolerate \r\n
    const char* le = line_end;
    if (le > p && le[-1] == '\r') --le;
    if (le == p) {  // blank line
      p = nl ? nl + 1 : end;
      continue;
    }
    if (row >= max_rows) return -1;
    int32_t* ids_row = ids_out + row * num_fields;

    // split on tabs
    const char* field = p;
    int col = 0;
    for (const char* q = p; q <= le && col <= num_fields; ++q) {
      if (q == le || *q == '\t') {
        int64_t flen = q - field;
        if (col == 0) {
          // labels are 0/1 in Criteo; digit-scan like the yx parser
          float lab = 0.0f;
          for (int64_t i = 0; i < flen; ++i) {
            if (field[i] < '0' || field[i] > '9') break;
            lab = lab * 10.0f + (field[i] - '0');
          }
          labels_out[row] = lab;
        } else if (col <= kNumInt) {
          ids_row[col - 1] = static_cast<int32_t>(
              offsets[col - 1] + int_bucket(field, flen, int_buckets));
        } else {
          int f = col - 1;
          int64_t local = flen > 0
              ? static_cast<int64_t>(fnv1a64(field, flen) % cat_buckets)
              : 0;
          ids_row[f] = static_cast<int32_t>(offsets[f] + local);
        }
        ++col;
        field = q + 1;
      }
    }
    // unfilled trailing columns -> missing buckets
    for (; col <= num_fields; ++col) {
      int f = col - 1;
      if (f < kNumInt) {
        ids_row[f] = static_cast<int32_t>(offsets[f] + 0);
      } else if (f < num_fields) {
        ids_row[f] = static_cast<int32_t>(offsets[f] + 0);
      }
    }
    ++row;
    p = nl ? nl + 1 : end;
  }
  return row;
}

}  // extern "C"
