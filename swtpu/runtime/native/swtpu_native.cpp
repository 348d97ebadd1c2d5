// swtpu native host runtime: FASTA parsing, 2-bit encoding, dense packing.
//
// Counterpart of the reference's native host layer
// (capi_sample_aligner/software-C,C++/src/main_test.c and
// include/aligner_Header.c): the hot host-side path that turns raw FASTA
// bytes into dense, sentinel-padded int8 tensors ready for device transfer.
// Exposed as a C ABI consumed via ctypes (see swtpu/runtime/native.py).
//
// Encoding follows the reference convention T=0 C=1 A=2 G=3
// (ScoreBank/ScoreBank_v1_tb.sv:44-52); unknown bases map to 0 in strict
// mode (the aligner_Header.c:34-39 quirk) or to the sentinel 4 otherwise.

#include <cstdint>
#include <cstring>

extern "C" {

// Build the base->code lookup table once.
static int8_t LUT_STRICT[256];
static int8_t LUT_SENTINEL[256];
static bool LUT_READY = false;

static void init_luts() {
  if (LUT_READY) return;
  for (int i = 0; i < 256; ++i) {
    LUT_STRICT[i] = 0;    // unknown -> 0 (reference quirk)
    LUT_SENTINEL[i] = 4;  // unknown -> never-match sentinel
  }
  const char bases[4] = {'T', 'C', 'A', 'G'};
  for (int c = 0; c < 4; ++c) {
    LUT_STRICT[(unsigned char)bases[c]] = (int8_t)c;
    LUT_STRICT[(unsigned char)(bases[c] + 32)] = (int8_t)c;  // lowercase
    LUT_SENTINEL[(unsigned char)bases[c]] = (int8_t)c;
    LUT_SENTINEL[(unsigned char)(bases[c] + 32)] = (int8_t)c;
  }
  LUT_READY = true;
}

// Parse FASTA text in memory: locate records, return name/sequence spans.
// Sequences may span multiple lines; spans index into `text`.
// Returns the number of records found (up to max_records).
// name_off/name_len: header spans (after '>'), seq_off/seq_len: per-record
// concatenated-sequence *byte length* (layout resolved by encode_records).
int64_t swtpu_fasta_index(const char* text, int64_t len,
                          int64_t* name_off, int64_t* name_len,
                          int64_t* rec_start, int64_t* rec_end,
                          int64_t* seq_len, int64_t max_records) {
  int64_t n = 0;
  int64_t i = 0;
  while (i < len && n < max_records) {
    if (text[i] == '>') {
      int64_t name_start = ++i;
      while (i < len && text[i] != '\n' && text[i] != '\r') ++i;
      name_off[n] = name_start;
      // trim name at first whitespace
      int64_t ne = name_start;
      while (ne < i && text[ne] != ' ' && text[ne] != '\t') ++ne;
      name_len[n] = ne - name_start;
      while (i < len && (text[i] == '\n' || text[i] == '\r')) ++i;
      int64_t body_start = i;
      int64_t bases = 0;
      while (i < len && text[i] != '>') {
        if (text[i] != '\n' && text[i] != '\r') ++bases;
        ++i;
      }
      rec_start[n] = body_start;
      rec_end[n] = i;
      seq_len[n] = bases;
      ++n;
    } else {
      ++i;
    }
  }
  return n;
}

// Encode one record span (skipping newlines) into `out` (capacity `width`),
// padding the tail with pad_code.  Returns the encoded base count.
static int64_t encode_span(const char* text, int64_t start, int64_t end,
                           int8_t* out, int64_t width, int8_t pad_code,
                           const int8_t* lut) {
  int64_t k = 0;
  for (int64_t i = start; i < end && k < width; ++i) {
    unsigned char c = (unsigned char)text[i];
    if (c == '\n' || c == '\r') continue;
    out[k++] = lut[c];
  }
  for (int64_t j = k; j < width; ++j) out[j] = pad_code;
  return k;
}

// Encode many record spans into a dense [n_records, width] int8 matrix.
// strict != 0 reproduces the reference's unknown->0 encoding.
void swtpu_encode_records(const char* text, const int64_t* rec_start,
                          const int64_t* rec_end, int64_t n_records,
                          int8_t* out, int64_t width, int8_t pad_code,
                          int32_t* lens, int32_t strict) {
  init_luts();
  const int8_t* lut = strict ? LUT_STRICT : LUT_SENTINEL;
  for (int64_t r = 0; r < n_records; ++r) {
    int64_t k = encode_span(text, rec_start[r], rec_end[r],
                            out + r * width, width, pad_code, lut);
    lens[r] = (int32_t)k;
  }
}

// Scatter rows of a dense encoded matrix into bucket-local batches:
// for each record r with assignment a[r] == bucket, copy row r of `src`
// (src_width cols) into the next free row of `dst` (dst_width cols,
// sentinel-padded), recording ids.  Returns rows written.
int64_t swtpu_pack_bucket(const int8_t* src, const int32_t* lens,
                          const int32_t* assign, int64_t n_records,
                          int32_t bucket, int64_t src_width,
                          int8_t* dst, int64_t dst_width, int8_t pad_code,
                          int32_t* ids, int32_t* out_lens, int64_t max_rows) {
  int64_t w = 0;
  for (int64_t r = 0; r < n_records && w < max_rows; ++r) {
    if (assign[r] != bucket) continue;
    const int8_t* row = src + r * src_width;
    int8_t* orow = dst + w * dst_width;
    int64_t L = lens[r] < dst_width ? lens[r] : dst_width;
    memcpy(orow, row, (size_t)L);
    for (int64_t j = L; j < dst_width; ++j) orow[j] = pad_code;
    ids[w] = (int32_t)r;
    out_lens[w] = (int32_t)L;
    ++w;
  }
  return w;
}

// Greedy shortest-stream planning for the wavefront feeder lanes: read r
// goes to the stream with the smallest fill (ties -> lowest index), exactly
// matching swtpu.bank.streams.pack_streams's np.argmin greedy — the
// priority-encoder dispatch (ScoreBank/PrioEncoder.v:16-22) in host code.
// Uses a binary heap of (fill, stream) pairs: O(n log S) instead of the
// Python loop's O(n S).  Returns the maximum fill across streams.
// emit_step[r] = fill_at_assign + len - 1 + drain, or -1 for empty reads.
int64_t swtpu_plan_streams(const int32_t* lens, int64_t n_reads, int64_t S,
                           int64_t drain, int32_t* emit_stream,
                           int64_t* emit_step) {
  struct Slot { int64_t fill; int64_t idx; };
  Slot* heap = new Slot[S];
  for (int64_t s = 0; s < S; ++s) heap[s] = {0, s};  // already a valid heap
  auto less = [](const Slot& a, const Slot& b) {
    return a.fill != b.fill ? a.fill < b.fill : a.idx < b.idx;
  };
  auto sift_down = [&](int64_t i) {
    for (;;) {
      int64_t l = 2 * i + 1, r = 2 * i + 2, m = i;
      if (l < S && less(heap[l], heap[m])) m = l;
      if (r < S && less(heap[r], heap[m])) m = r;
      if (m == i) break;
      Slot tmp = heap[i]; heap[i] = heap[m]; heap[m] = tmp;
      i = m;
    }
  };
  for (int64_t r = 0; r < n_reads; ++r) {
    int64_t len = lens[r];
    if (len == 0) {
      emit_stream[r] = 0;
      emit_step[r] = -1;  // zero-length read: score 0 by definition
      continue;
    }
    Slot& top = heap[0];
    emit_stream[r] = (int32_t)top.idx;
    emit_step[r] = top.fill + len - 1 + drain;
    top.fill += len;
    sift_down(0);
  }
  int64_t max_fill = 0;
  for (int64_t s = 0; s < S; ++s)
    if (heap[s].fill > max_fill) max_fill = heap[s].fill;
  delete[] heap;
  return max_fill;
}

// Copy reads into their planned stream slots (stream prefilled with the pad
// char by the caller), OR-ing the first-char flag bit.
void swtpu_fill_streams(const int8_t* src, const int32_t* lens,
                        int64_t n_reads, int64_t src_width,
                        const int32_t* emit_stream, const int64_t* emit_step,
                        int64_t drain, int8_t flag_bit, int8_t* stream,
                        int64_t T) {
  for (int64_t r = 0; r < n_reads; ++r) {
    int64_t len = lens[r];
    if (len == 0 || emit_step[r] < 0) continue;
    int64_t start = emit_step[r] - drain - (len - 1);
    int8_t* dst = stream + emit_stream[r] * T + start;
    memcpy(dst, src + r * src_width, (size_t)len);
    dst[0] = (int8_t)(dst[0] | flag_bit);
  }
}

// 4-bases-per-byte LSB-first packing (aligner_Header.c:30-41) for
// host<->host transfer economy.
void swtpu_pack_2bit(const int8_t* codes, int64_t n, uint8_t* out) {
  int64_t nb = (n + 3) / 4;
  for (int64_t b = 0; b < nb; ++b) out[b] = 0;
  for (int64_t i = 0; i < n; ++i)
    out[i / 4] |= (uint8_t)((codes[i] & 3) << (2 * (i % 4)));
}

void swtpu_unpack_2bit(const uint8_t* packed, int64_t n, int8_t* out) {
  for (int64_t i = 0; i < n; ++i)
    out[i] = (int8_t)((packed[i / 4] >> (2 * (i % 4))) & 3);
}

// Full stream-wire packing in one pass: 2-bit codes 4/byte LSB-first plus
// the first-char flag bitmap 8/byte (flag bit 3 of the char stream) — the
// host side of the 2.5-bit/char transfer format (see
// swtpu.bank.streams.pack_stream_wire; device inverse: unpack_stream_wire).
// stream: [N, T] row-major, T % 8 == 0; codes: [N, T/4]; flags: [N, T/8].
void swtpu_pack_wire(const int8_t* stream, int64_t N, int64_t T,
                     uint8_t* codes, uint8_t* flags) {
  const int64_t cq = T / 4, fq = T / 8;
  for (int64_t r = 0; r < N; ++r) {
    const int8_t* row = stream + r * T;
    uint8_t* crow = codes + r * cq;
    uint8_t* frow = flags + r * fq;
    for (int64_t b = 0; b < cq; ++b) {
      const int8_t* p = row + b * 4;
      crow[b] = (uint8_t)((p[0] & 3) | ((p[1] & 3) << 2) | ((p[2] & 3) << 4) |
                          ((p[3] & 3) << 6));
    }
    for (int64_t b = 0; b < fq; ++b) {
      const int8_t* p = row + b * 8;
      uint8_t f = 0;
      for (int k = 0; k < 8; ++k) f |= (uint8_t)(((p[k] >> 3) & 1) << k);
      frow[b] = f;
    }
  }
}

}  // extern "C"
