// Native helpers for sketchtpu: CRC32C, Snappy raw block codec, and the
// order-dependent FASTQ k-mer count filter.
//
// These are the host-side runtime pieces that sit around the device compute
// path: framed-Snappy container IO (.skm/.ski files are snappy-framed CBOR /
// MessagePack, see /root/reference/src/sketch/multisketch.rs:80-103 and
// src/inverted.rs:194-225) and the sequential read-filtering loop whose
// result is order-dependent (src/sketch/mod.rs:198-208 with
// src/hashing/bloom_filter.rs) and therefore cannot be expressed as a
// data-parallel reduction.
//
// Formats are implemented from their public specifications
// (https://github.com/google/snappy/blob/main/format_description.txt).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -o _sketchtpu_native.so sketchtpu_native.cpp

#include <cstdint>
#include <charconv>
#include <cmath>
#include <cstring>
#include <cstddef>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli), slice-by-8 software implementation.
// ---------------------------------------------------------------------------

static uint32_t crc32c_table[8][256];
static bool crc32c_init_done = false;

static void crc32c_init() {
    if (crc32c_init_done) return;
    const uint32_t poly = 0x82F63B78u;  // reflected CRC32C polynomial
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t crc = i;
        for (int j = 0; j < 8; j++)
            crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
        crc32c_table[0][i] = crc;
    }
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t crc = crc32c_table[0][i];
        for (int s = 1; s < 8; s++) {
            crc = crc32c_table[0][crc & 0xFF] ^ (crc >> 8);
            crc32c_table[s][i] = crc;
        }
    }
    crc32c_init_done = true;
}

uint32_t stpu_crc32c(const uint8_t* data, size_t len, uint32_t seed) {
    crc32c_init();
    uint32_t crc = ~seed;
    size_t i = 0;
    while (len - i >= 8) {
        uint32_t lo, hi;
        memcpy(&lo, data + i, 4);
        memcpy(&hi, data + i + 4, 4);
        lo ^= crc;
        crc = crc32c_table[7][lo & 0xFF] ^ crc32c_table[6][(lo >> 8) & 0xFF] ^
              crc32c_table[5][(lo >> 16) & 0xFF] ^ crc32c_table[4][lo >> 24] ^
              crc32c_table[3][hi & 0xFF] ^ crc32c_table[2][(hi >> 8) & 0xFF] ^
              crc32c_table[1][(hi >> 16) & 0xFF] ^ crc32c_table[0][hi >> 24];
        i += 8;
    }
    for (; i < len; i++)
        crc = crc32c_table[0][(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
    return ~crc;
}

// ---------------------------------------------------------------------------
// Snappy raw block format.
// ---------------------------------------------------------------------------

static size_t write_varint(uint8_t* out, uint64_t v) {
    size_t n = 0;
    while (v >= 0x80) {
        out[n++] = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    out[n++] = (uint8_t)v;
    return n;
}

// Maximum compressed size for `n` input bytes (worst case all literals).
size_t stpu_snappy_max_compressed(size_t n) { return 32 + n + n / 6; }

// LZ77 compressor emitting the snappy raw element stream. This is a
// faithful re-implementation of the classic snappy block algorithm
// (64 KiB blocks, 2^8..2^14-entry hash table sized to the block,
// multiplicative hash 0x1e35a7bd, the skip/32 miss accelerator, and the
// 68/64-split copy emission) so that the emitted bytes are identical to
// what the reference's `snap` crate writes — .skm/.ski containers built
// here byte-match reference-written fixtures, not just decode-compat.
// Returns compressed size, or 0 on error (out buffer too small).

static inline uint32_t snappy_load32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;  // little-endian hosts only (x86-64/aarch64)
}

static inline uint32_t snappy_hash(uint32_t bytes, int shift) {
    return (bytes * 0x1E35A7BDu) >> shift;
}

// Emit a literal run [start, start+len) into out. len <= 2^32.
static bool snappy_emit_literal(const uint8_t* in, size_t start, size_t len,
                                uint8_t* out, size_t out_cap, size_t& op) {
    if (len == 0) return true;
    size_t l = len - 1;
    if (l < 60) {
        if (op + 1 + len > out_cap) return false;
        out[op++] = (uint8_t)(l << 2);
    } else if (l < (1u << 8)) {
        if (op + 2 + len > out_cap) return false;
        out[op++] = (uint8_t)(60 << 2);
        out[op++] = (uint8_t)l;
    } else if (l < (1u << 16)) {
        if (op + 3 + len > out_cap) return false;
        out[op++] = (uint8_t)(61 << 2);
        out[op++] = (uint8_t)l;
        out[op++] = (uint8_t)(l >> 8);
    } else if (l < (1ull << 24)) {
        if (op + 4 + len > out_cap) return false;
        out[op++] = (uint8_t)(62 << 2);
        out[op++] = (uint8_t)l;
        out[op++] = (uint8_t)(l >> 8);
        out[op++] = (uint8_t)(l >> 16);
    } else {
        if (op + 5 + len > out_cap) return false;
        out[op++] = (uint8_t)(63 << 2);
        out[op++] = (uint8_t)l;
        out[op++] = (uint8_t)(l >> 8);
        out[op++] = (uint8_t)(l >> 16);
        out[op++] = (uint8_t)(l >> 24);
    }
    memcpy(out + op, in + start, len);
    op += len;
    return true;
}

// One copy element of length 4..64 (type-1 two-byte form when it fits).
static bool snappy_emit_copy_upto64(size_t offset, size_t len, uint8_t* out,
                                    size_t out_cap, size_t& op) {
    if (len < 12 && offset < 2048) {
        if (op + 2 > out_cap) return false;
        out[op++] =
            (uint8_t)(1 | (((len - 4) & 7) << 2) | ((offset >> 8) << 5));
        out[op++] = (uint8_t)(offset & 0xFF);
    } else {
        if (op + 3 > out_cap) return false;
        out[op++] = (uint8_t)(2 | ((len - 1) << 2));
        out[op++] = (uint8_t)(offset & 0xFF);
        out[op++] = (uint8_t)(offset >> 8);
    }
    return true;
}

// Copy emission with the reference algorithm's exact chunking: 64s while
// len >= 68, then a 60 if len > 64, then the remainder.
static bool snappy_emit_copy(size_t offset, size_t len, uint8_t* out,
                             size_t out_cap, size_t& op) {
    while (len >= 68) {
        if (!snappy_emit_copy_upto64(offset, 64, out, out_cap, op))
            return false;
        len -= 64;
    }
    if (len > 64) {
        if (!snappy_emit_copy_upto64(offset, 60, out, out_cap, op))
            return false;
        len -= 60;
    }
    return snappy_emit_copy_upto64(offset, len, out, out_cap, op);
}

// Compress one block (<= 64 KiB) appending elements to out at op.
static bool snappy_compress_block(const uint8_t* in, size_t n, uint8_t* out,
                                  size_t out_cap, size_t& op,
                                  uint16_t* table) {
    size_t table_size = 256;
    const size_t kMaxTableSize = 1u << 14;
    while (table_size < kMaxTableSize && table_size < n) table_size <<= 1;
    memset(table, 0, table_size * sizeof(uint16_t));
    const int shift = 32 - __builtin_ctzll(table_size);

    const size_t kInputMarginBytes = 15;
    size_t next_emit = 0;
    size_t ip = 0;
    if (n >= kInputMarginBytes) {
        const size_t ip_limit = n - kInputMarginBytes;
        ip = 1;
        uint32_t next_hash = snappy_hash(snappy_load32(in + ip), shift);
        for (;;) {
            uint32_t skip = 32;
            size_t next_ip = ip;
            size_t candidate;
            do {
                ip = next_ip;
                uint32_t hash = next_hash;
                uint32_t bytes_between = skip++ >> 5;
                next_ip = ip + bytes_between;
                if (next_ip > ip_limit) goto emit_remainder;
                next_hash = snappy_hash(snappy_load32(in + next_ip), shift);
                candidate = table[hash];
                table[hash] = (uint16_t)ip;
            } while (snappy_load32(in + ip) != snappy_load32(in + candidate));

            if (!snappy_emit_literal(in, next_emit, ip - next_emit, out,
                                     out_cap, op))
                return false;

            uint64_t input_bytes = 0;
            for (;;) {
                size_t base = ip;
                size_t matched = 4;
                while (ip + matched < n &&
                       in[candidate + matched] == in[ip + matched])
                    matched++;
                ip += matched;
                if (!snappy_emit_copy(base - candidate, matched, out,
                                      out_cap, op))
                    return false;
                next_emit = ip;
                if (ip >= ip_limit) goto emit_remainder;
                memcpy(&input_bytes, in + ip - 1, 8);
                uint32_t prev_hash =
                    snappy_hash((uint32_t)input_bytes, shift);
                table[prev_hash] = (uint16_t)(ip - 1);
                uint32_t cur_hash =
                    snappy_hash((uint32_t)(input_bytes >> 8), shift);
                candidate = table[cur_hash];
                table[cur_hash] = (uint16_t)ip;
                if ((uint32_t)(input_bytes >> 8) !=
                    snappy_load32(in + candidate))
                    break;
            }
            ip++;
            next_hash = snappy_hash(snappy_load32(in + ip), shift);
        }
    }
emit_remainder:
    return snappy_emit_literal(in, next_emit, n - next_emit, out, out_cap,
                               op);
}

size_t stpu_snappy_compress(const uint8_t* in, size_t n, uint8_t* out,
                            size_t out_cap) {
    if (out_cap < 16) return 0;
    size_t op = write_varint(out, n);
    if (n == 0) return op;
    const size_t kBlockSize = 1u << 16;
    std::vector<uint16_t> table(1u << 14);
    for (size_t pos = 0; pos < n; pos += kBlockSize) {
        size_t blk = n - pos < kBlockSize ? n - pos : kBlockSize;
        if (!snappy_compress_block(in + pos, blk, out, out_cap, op,
                                   table.data()))
            return 0;
    }
    return op;
}

// Decompresses a snappy raw block. Returns the uncompressed size, or
// (size_t)-1 on malformed input / output overflow.
size_t stpu_snappy_decompress(const uint8_t* in, size_t n, uint8_t* out,
                              size_t out_cap) {
    size_t ip = 0;
    // read uncompressed-length varint
    uint64_t ulen = 0;
    int shift = 0;
    while (true) {
        if (ip >= n || shift > 63) return (size_t)-1;
        uint8_t b = in[ip++];
        ulen |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) break;
        shift += 7;
    }
    if (ulen > out_cap) return (size_t)-1;
    size_t op = 0;
    while (ip < n) {
        uint8_t tag = in[ip++];
        uint32_t kind = tag & 3;
        if (kind == 0) {  // literal
            size_t len = (tag >> 2) + 1;
            if (len > 60) {
                size_t extra = len - 60;
                if (ip + extra > n) return (size_t)-1;
                len = 0;
                for (size_t i = 0; i < extra; i++) len |= (size_t)in[ip + i] << (8 * i);
                len += 1;
                ip += extra;
            }
            if (ip + len > n || op + len > ulen) return (size_t)-1;
            memcpy(out + op, in + ip, len);
            ip += len;
            op += len;
        } else {
            size_t len, offset;
            if (kind == 1) {
                len = ((tag >> 2) & 7) + 4;
                if (ip >= n) return (size_t)-1;
                offset = ((size_t)(tag >> 5) << 8) | in[ip++];
            } else if (kind == 2) {
                len = (tag >> 2) + 1;
                if (ip + 2 > n) return (size_t)-1;
                offset = (size_t)in[ip] | ((size_t)in[ip + 1] << 8);
                ip += 2;
            } else {
                len = (tag >> 2) + 1;
                if (ip + 4 > n) return (size_t)-1;
                offset = (size_t)in[ip] | ((size_t)in[ip + 1] << 8) |
                         ((size_t)in[ip + 2] << 16) | ((size_t)in[ip + 3] << 24);
                ip += 4;
            }
            if (offset == 0 || offset > op || op + len > ulen) return (size_t)-1;
            // byte-by-byte copy handles overlapping (RLE) copies
            for (size_t i = 0; i < len; i++) {
                out[op] = out[op - offset];
                op++;
            }
        }
    }
    return op == ulen ? op : (size_t)-1;
}

// ---------------------------------------------------------------------------
// FASTQ min-count filter + bin minimum (order-dependent sequential loop).
//
// Mirrors Sketch::bin_sign with a KmerFilter
// (/root/reference/src/sketch/mod.rs:198-208,
//  /root/reference/src/hashing/bloom_filter.rs:43-152): a sign only updates
// its bin minimum if it is strictly smaller than the current minimum AND the
// count filter (blocked bloom filter + exact counts for >=3) has seen the
// k-mer min_count times. The bloom filter is only consulted for signs that
// would improve their bin, so the result depends on stream order.
// ---------------------------------------------------------------------------

struct CountFilter {
    static const size_t BLOOM_WIDTH = 1ull << 27;
    static const size_t BITS_PER_ENTRY = 12;
    std::vector<uint64_t> buffer;
    std::unordered_map<uint64_t, uint16_t> counts;
    uint16_t min_count;

    explicit CountFilter(uint16_t mc) : min_count(mc) {
        double sz = (double)BLOOM_WIDTH * ((double)BITS_PER_ENTRY / 8.0) / 64.0;
        size_t buf_size = (size_t)(sz + 0.5);
        if (mc >= 2) buffer.assign(buf_size, 0);
    }

    static uint64_t cheap_mix(uint64_t key) {
        return (key ^ (key >> 31)) * 0x85D059AA333121CFull;
    }
    static uint64_t reduce(uint64_t key, uint64_t range) {
        return (uint64_t)(((unsigned __int128)key * range) >> 64);
    }
    static uint64_t fingerprint(uint64_t key) {
        return (1ull << (key & 63)) | (1ull << ((key >> 6) & 63)) |
               (1ull << ((key >> 12) & 63)) | (1ull << ((key >> 18) & 63)) |
               (1ull << ((key >> 24) & 63));
    }
    bool bloom_add_and_check(uint64_t key) {
        uint64_t f = fingerprint(key);
        uint64_t& v = buffer[reduce(cheap_mix(key), buffer.size())];
        if ((v & f) == f) return true;
        v |= f;
        return false;
    }
    // returns 0 if passed (Ordering::Equal), nonzero otherwise
    int filter(uint64_t hash) {
        if (min_count <= 1) return 0;
        if (min_count == 2) return bloom_add_and_check(hash) ? 0 : -1;
        if (!bloom_add_and_check(hash)) return -1;
        uint16_t count;
        auto it = counts.find(hash);
        if (it == counts.end()) {
            counts.emplace(hash, 2);
            count = 2;
        } else {
            if (it->second < 0xFFFF) it->second++;
            count = it->second;
        }
        return min_count == count ? 0 : (min_count < count ? -1 : 1);
    }
};

// signs: stream of sign values (already reduced mod 2^61-1), in sequence
// order. bins (len nbins) must be pre-filled with UINT64_MAX.
void stpu_filter_bin_signs(const uint64_t* signs, size_t n, uint16_t min_count,
                           uint64_t binsize, uint64_t* bins, size_t nbins) {
    CountFilter filter(min_count);
    for (size_t i = 0; i < n; i++) {
        uint64_t sign = signs[i];
        size_t bin = (size_t)(sign / binsize);
        if (bin >= nbins) continue;
        if (sign < bins[bin] && filter.filter(sign) == 0) bins[bin] = sign;
    }
}

// Unfiltered variant (FASTA path) for fast host-side oracle use.
void stpu_bin_signs(const uint64_t* signs, size_t n, uint64_t binsize,
                    uint64_t* bins, size_t nbins) {
    for (size_t i = 0; i < n; i++) {
        uint64_t sign = signs[i];
        size_t bin = (size_t)(sign / binsize);
        if (bin < nbins && sign < bins[bin]) bins[bin] = sign;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// f32 text formatting (Rust `Display` semantics: shortest round-trip digits,
// positional notation, no trailing ".0") and bulk distance-line assembly.
// std::to_chars produces the shortest round-trip form but may pick scientific
// notation; the exponent is expanded to positional here so output matches the
// reference byte-for-byte (distance_matrix.rs:175-209).
// ---------------------------------------------------------------------------

static int fmt_f32_positional(float v, char* out) {
    if (std::isnan(v)) { std::memcpy(out, "NaN", 3); return 3; }
    if (std::isinf(v)) {
        if (v < 0) { std::memcpy(out, "-inf", 4); return 4; }
        std::memcpy(out, "inf", 3); return 3;
    }
    char tmp[48];
    auto res = std::to_chars(tmp, tmp + sizeof(tmp), v);
    int n = (int)(res.ptr - tmp);
    int epos = -1;
    for (int i = 0; i < n; i++) {
        if (tmp[i] == 'e') { epos = i; break; }
    }
    if (epos < 0) { std::memcpy(out, tmp, n); return n; }

    // scientific: [-]D[.DDDD]e[-+]XX -> positional
    int p = 0, o = 0;
    if (tmp[0] == '-') { out[o++] = '-'; p = 1; }
    char digits[40];
    int nd = 0;
    for (int i = p; i < epos; i++)
        if (tmp[i] != '.') digits[nd++] = tmp[i];
    int exp = 0, esign = 1, i = epos + 1;
    if (tmp[i] == '-') { esign = -1; i++; } else if (tmp[i] == '+') { i++; }
    for (; i < n; i++) exp = exp * 10 + (tmp[i] - '0');
    exp *= esign;
    // value = digits[0].digits[1:] * 10^exp
    if (exp >= nd - 1) {
        for (int d = 0; d < nd; d++) out[o++] = digits[d];
        for (int z = 0; z < exp - (nd - 1); z++) out[o++] = '0';
    } else if (exp >= 0) {
        for (int d = 0; d <= exp; d++) out[o++] = digits[d];
        out[o++] = '.';
        for (int d = exp + 1; d < nd; d++) out[o++] = digits[d];
    } else {
        out[o++] = '0'; out[o++] = '.';
        for (int z = 0; z < -exp - 1; z++) out[o++] = '0';
        for (int d = 0; d < nd; d++) out[o++] = digits[d];
    }
    return o;
}

extern "C" {

// values -> fixed-stride (64B) char slots + lengths (for tests / columns).
void stpu_format_f32(const float* values, int64_t n, char* out,
                     int32_t* lens) {
    for (int64_t i = 0; i < n; i++)
        lens[i] = fmt_f32_positional(values[i], out + 64 * i);
}

// Bulk "row\tcol\tv1[\tv2]\n" line assembly.
// names_r/off_r: row-name table (name i = bytes [off[i], off[i+1]));
// names_c/off_c: column-name table; rows/cols: per-line indices;
// v2 == nullptr -> single-value lines. Returns bytes written, or -1 if the
// output capacity would be exceeded.
int64_t stpu_format_dist_lines(
    const char* names_r, const int64_t* off_r,
    const char* names_c, const int64_t* off_c,
    const int32_t* rows, const int32_t* cols,
    const float* v1, const float* v2,
    int64_t n, char* out, int64_t cap) {
    int64_t o = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t r0 = off_r[rows[i]], r1 = off_r[rows[i] + 1];
        int64_t c0 = off_c[cols[i]], c1 = off_c[cols[i] + 1];
        int64_t need = (r1 - r0) + (c1 - c0) + 2 * 64 + 4;
        if (o + need > cap) return -1;
        std::memcpy(out + o, names_r + r0, r1 - r0); o += r1 - r0;
        out[o++] = '\t';
        std::memcpy(out + o, names_c + c0, c1 - c0); o += c1 - c0;
        out[o++] = '\t';
        o += fmt_f32_positional(v1[i], out + o);
        if (v2 != nullptr) {
            out[o++] = '\t';
            o += fmt_f32_positional(v2[i], out + o);
        }
        out[o++] = '\n';
    }
    return o;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// DNA fastx parsing: the per-line Python loop is the sketch pipeline's
// host bottleneck on large inputs. Operates on the fully decompressed byte
// buffer; semantics replicate ingest/fastx.read_dna_sample exactly
// (line strip(), blank-line tolerance, per-record break, quality-byte
// filter against raw PHRED+33, break = #valid bases before each invalid).
// Returns 0 on success, negative on malformed input (caller falls back to
// the Python parser for its error messages).
// ---------------------------------------------------------------------------

namespace {

struct DnaParseOut {
    uint8_t* codes;       // caller-allocated, capacity n
    int64_t* breaks;      // caller-allocated, capacity n + 1 (worst case)
    int64_t n_codes = 0;
    int64_t n_breaks = 0;
    int64_t acgt[4] = {0, 0, 0, 0};
    int64_t non_acgt = 0;
};

inline bool is_space(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
           c == '\f';
}

// [s, e) with ascii whitespace stripped from both ends
inline void strip_span(const uint8_t* b, int64_t& s, int64_t& e) {
    while (s < e && is_space(b[s])) s++;
    while (e > s && is_space(b[e - 1])) e--;
}

inline void emit_seq(const uint8_t* seq, const uint8_t* qual, int64_t len,
                     const uint8_t* enc, int min_qual, DnaParseOut& o) {
    // one record's sequence (qual may be null): append codes + breaks
    int64_t rec_valid = 0;
    for (int64_t i = 0; i < len; i++) {
        uint8_t code = enc[seq[i]];
        bool ok = code < 4;
        if (qual != nullptr && min_qual > 0 && qual[i] < (uint8_t)min_qual)
            ok = false;
        if (ok) {
            o.codes[o.n_codes++] = code;
            o.acgt[code]++;
            rec_valid++;
        } else {
            o.non_acgt++;
            o.breaks[o.n_breaks++] = o.n_codes;  // #valid before this base
        }
    }
    (void)rec_valid;
    o.breaks[o.n_breaks++] = o.n_codes;  // end-of-record break
}

}  // namespace

extern "C" {

// buf: whole decompressed file; fmt: 0 = fasta, 1 = fastq.
// codes cap >= n; breaks cap >= n + #records + 1 (n + n/2 is safe: every
// break consumes an input byte or terminates a record of >= 2 lines).
int stpu_parse_dna(const uint8_t* buf, int64_t n, int fmt,
                   const uint8_t* enc, int min_qual, uint8_t* codes,
                   int64_t* breaks, int64_t* n_codes, int64_t* n_breaks,
                   int64_t* acgt, int64_t* non_acgt) {
    DnaParseOut o;
    o.codes = codes;
    o.breaks = breaks;
    int64_t pos = 0;
    if (fmt == 0) {
        // FASTA: accumulate body lines per record; process base-by-base,
        // breaks only depend on running valid count so no buffering needed
        bool started = false;
        bool pending_record = false;  // emitted bases since last header?
        while (pos < n) {
            int64_t e = pos;
            while (e < n && buf[e] != '\n') e++;
            int64_t s = pos;
            int64_t se = e;
            strip_span(buf, s, se);
            pos = e + 1;
            if (s == se) continue;  // blank line
            if (buf[s] == '>') {
                if (started && pending_record) {
                    o.breaks[o.n_breaks++] = o.n_codes;  // end previous record
                }
                started = true;
                pending_record = true;
                continue;
            }
            if (!started) return -1;
            // body line: no end-of-record break yet
            for (int64_t i = s; i < se; i++) {
                uint8_t code = enc[buf[i]];
                if (code < 4) {
                    o.codes[o.n_codes++] = code;
                    o.acgt[code]++;
                } else {
                    o.non_acgt++;
                    o.breaks[o.n_breaks++] = o.n_codes;
                }
            }
        }
        if (started && pending_record)
            o.breaks[o.n_breaks++] = o.n_codes;
    } else {
        // FASTQ: 4-line records, blank lines tolerated between records
        while (pos < n) {
            int64_t e = pos;
            while (e < n && buf[e] != '\n') e++;
            int64_t hs = pos, he = e;
            strip_span(buf, hs, he);
            pos = e + 1;
            if (hs == he) continue;
            if (buf[hs] != '@') return -2;
            // seq line
            if (pos >= n) return -3;
            e = pos;
            while (e < n && buf[e] != '\n') e++;
            int64_t ss = pos, se = e;
            strip_span(buf, ss, se);
            pos = e + 1;
            // plus line (must start with '+', unstripped leading check on
            // the raw line like Python's startswith on the readline)
            if (pos >= n) return -4;
            e = pos;
            while (e < n && buf[e] != '\n') e++;
            if (buf[pos] != '+') return -5;
            pos = e + 1;
            // qual line
            if (pos > n) return -6;
            e = pos;
            while (e < n && buf[e] != '\n') e++;
            int64_t qs = pos, qe = e;
            strip_span(buf, qs, qe);
            pos = e + 1;
            if (qe - qs != se - ss) return -7;
            emit_seq(buf + ss, buf + qs, se - ss, enc, min_qual, o);
        }
    }
    *n_codes = o.n_codes;
    *n_breaks = o.n_breaks;
    for (int i = 0; i < 4; i++) acgt[i] = o.acgt[i];
    *non_acgt = o.non_acgt;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// AA fasta parsing: like stpu_parse_dna but emits the record bytes with
// invalid residues replaced by a separator byte (aahash_iterator.rs:100-107
// keeps invalid residues in-stream as SEQSEP), plus per-record offsets so
// the caller can split records (--concat-fasta) or join them with SEQSEP.
// Returns 0 on success, -1 on malformed input (caller falls back to Python).
// ---------------------------------------------------------------------------

extern "C" {

int stpu_parse_aa(const uint8_t* buf, int64_t n, const uint8_t* valid_tab,
                  uint8_t sep, uint8_t* seq, int64_t* rec_off,
                  int64_t* n_seq, int64_t* n_rec, int64_t* invalid) {
    int64_t pos = 0, o = 0, recs = 0, bad = 0;
    bool started = false;
    while (pos < n) {
        int64_t e = pos;
        while (e < n && buf[e] != '\n') e++;
        int64_t s = pos, se = e;
        strip_span(buf, s, se);
        pos = e + 1;
        if (s == se) continue;
        if (buf[s] == '>') {
            if (started) rec_off[recs++] = o;
            started = true;
            continue;
        }
        if (!started) return -1;
        for (int64_t i = s; i < se; i++) {
            if (valid_tab[buf[i]]) {
                seq[o++] = buf[i];
            } else {
                seq[o++] = sep;
                bad++;
            }
        }
    }
    if (started) rec_off[recs++] = o;
    *n_seq = o;
    *n_rec = recs;
    *invalid = bad;
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// .ski index-body serialization: the per-bin {u16 sign -> roaring bitmap}
// msgpack maps. The Python path costs ~20us per entry (millions of entries
// at 100k+ samples); these emit/parse the exact same bytes in one pass.
// Formats: MessagePack (uint keys minimal-width, bin8/16/32 values) and the
// RoaringFormatSpec no-run-container layout (cookie 12346), matching
// formats/msgpack.py and formats/roaring.py byte-for-byte.
// ---------------------------------------------------------------------------

namespace {

inline void put_u16le(uint8_t* p, uint16_t v) { p[0] = v & 0xFF; p[1] = v >> 8; }
inline void put_u32le(uint8_t* p, uint32_t v) {
    p[0] = v & 0xFF; p[1] = (v >> 8) & 0xFF; p[2] = (v >> 16) & 0xFF; p[3] = v >> 24;
}

// roaring blob for sorted u32 members; returns bytes written or -1 on cap
int64_t roaring_emit(const uint32_t* vals, int64_t n, uint8_t* out, int64_t cap) {
    // count containers (distinct high-16 keys) and the exact data size
    int64_t nc = 0, data_size = 0;
    for (int64_t i = 0; i < n;) {
        uint16_t key = vals[i] >> 16;
        int64_t j = i;
        while (j < n && (vals[j] >> 16) == key) j++;
        data_size += (j - i) <= 4096 ? (j - i) * 2 : 8192;
        i = j;
        nc++;
    }
    int64_t header = 8 + 4 * nc;
    int64_t pos = header + 4 * nc;  // offsets section then container data
    if (pos + data_size > cap) return -1;
    put_u32le(out, 12346u);
    put_u32le(out + 4, (uint32_t)nc);
    uint8_t* desc = out + 8;
    uint8_t* offs = out + header;
    int64_t i = 0;
    for (int64_t c = 0; c < nc; c++) {
        uint16_t key = vals[i] >> 16;
        int64_t j = i;
        while (j < n && (vals[j] >> 16) == key) j++;
        int64_t card = j - i;
        put_u16le(desc, key); desc += 2;
        put_u16le(desc, (uint16_t)(card - 1)); desc += 2;
        put_u32le(offs, (uint32_t)pos); offs += 4;
        if (card <= 4096) {
            for (int64_t t = i; t < j; t++) {
                put_u16le(out + pos, (uint16_t)(vals[t] & 0xFFFF));
                pos += 2;
            }
        } else {
            uint8_t* bits = out + pos;
            std::memset(bits, 0, 8192);
            for (int64_t t = i; t < j; t++) {
                uint16_t lo = vals[t] & 0xFFFF;
                bits[lo >> 3] |= (uint8_t)(1u << (lo & 7));
            }
            pos += 8192;
        }
        i = j;
    }
    return pos;
}

}  // namespace

extern "C" {

// One bin's msgpack map {sign: roaring bin}: signs ascending (n_entries
// distinct u16), members flat sorted-ascending u32 with entry offsets.
// Returns bytes written, or -1 if cap insufficient.
int64_t stpu_ski_bin_msgpack(const uint16_t* signs, const int64_t* ent_off,
                             const uint32_t* members, int64_t n_entries,
                             uint8_t* out, int64_t cap) {
    int64_t o = 0;
    if (n_entries < 16) {
        if (o + 1 > cap) return -1;
        out[o++] = 0x80 | (uint8_t)n_entries;
    } else if (n_entries < (1 << 16)) {
        if (o + 3 > cap) return -1;
        out[o++] = 0xDE;
        out[o++] = (n_entries >> 8) & 0xFF;
        out[o++] = n_entries & 0xFF;
    } else {
        if (o + 5 > cap) return -1;
        out[o++] = 0xDF;
        out[o++] = (n_entries >> 24) & 0xFF;
        out[o++] = (n_entries >> 16) & 0xFF;
        out[o++] = (n_entries >> 8) & 0xFF;
        out[o++] = n_entries & 0xFF;
    }
    for (int64_t e = 0; e < n_entries; e++) {
        uint16_t sign = signs[e];
        if (o + 3 > cap) return -1;
        if (sign < 0x80) {
            out[o++] = (uint8_t)sign;
        } else if (sign < 0x100) {
            out[o++] = 0xCC;
            out[o++] = (uint8_t)sign;
        } else {
            out[o++] = 0xCD;
            out[o++] = sign >> 8;
            out[o++] = sign & 0xFF;
        }
        // roaring blob into scratch position after a reserved bin header;
        // bin header size depends on blob length, so emit blob at o+5 max
        // then move if needed
        uint8_t tmp_hdr[5];
        int64_t blob_at = o + 5;
        int64_t blen = roaring_emit(members + ent_off[e], ent_off[e + 1] - ent_off[e],
                                    out + blob_at, cap - blob_at);
        if (blen < 0) return -1;
        int hdr;
        if (blen < (1 << 8)) {
            tmp_hdr[0] = 0xC4; tmp_hdr[1] = (uint8_t)blen; hdr = 2;
        } else if (blen < (1 << 16)) {
            tmp_hdr[0] = 0xC5; tmp_hdr[1] = blen >> 8; tmp_hdr[2] = blen & 0xFF; hdr = 3;
        } else {
            tmp_hdr[0] = 0xC6;
            tmp_hdr[1] = (blen >> 24) & 0xFF; tmp_hdr[2] = (blen >> 16) & 0xFF;
            tmp_hdr[3] = (blen >> 8) & 0xFF; tmp_hdr[4] = blen & 0xFF; hdr = 5;
        }
        std::memcpy(out + o, tmp_hdr, hdr);
        if (hdr != 5) std::memmove(out + o + hdr, out + blob_at, blen);
        o += hdr + blen;
    }
    return o;
}

// Parse one bin's msgpack map and emit (member, sign) pairs.
// Returns bytes consumed (>0) and sets *n_out, or a negative code on any
// unsupported encoding (caller falls back to the Python reader).
int64_t stpu_ski_bin_unpack(const uint8_t* buf, int64_t len,
                            uint32_t* members, uint16_t* signs,
                            int64_t out_cap, int64_t* n_out) {
    int64_t pos = 0, no = 0;
    if (pos >= len) return -1;
    uint8_t b = buf[pos++];
    int64_t n_entries;
    if ((b & 0xF0) == 0x80) n_entries = b & 0x0F;
    else if (b == 0xDE) {
        if (pos + 2 > len) return -1;
        n_entries = ((int64_t)buf[pos] << 8) | buf[pos + 1]; pos += 2;
    } else if (b == 0xDF) {
        if (pos + 4 > len) return -1;
        n_entries = ((int64_t)buf[pos] << 24) | ((int64_t)buf[pos+1] << 16) |
                    ((int64_t)buf[pos+2] << 8) | buf[pos+3]; pos += 4;
    } else return -2;
    for (int64_t e = 0; e < n_entries; e++) {
        if (pos >= len) return -1;
        uint8_t kb = buf[pos++];
        uint32_t sign;
        if (kb < 0x80) sign = kb;
        else if (kb == 0xCC) { if (pos + 1 > len) return -1; sign = buf[pos]; pos += 1; }
        else if (kb == 0xCD) {
            if (pos + 2 > len) return -1;
            sign = ((uint32_t)buf[pos] << 8) | buf[pos + 1]; pos += 2;
        } else if (kb == 0xCE) {
            if (pos + 4 > len) return -1;
            sign = ((uint32_t)buf[pos] << 24) | ((uint32_t)buf[pos+1] << 16) |
                   ((uint32_t)buf[pos+2] << 8) | buf[pos+3]; pos += 4;
        } else return -3;
        if (sign > 0xFFFF) return -3;
        if (pos >= len) return -1;
        uint8_t vb = buf[pos++];
        int64_t blen;
        if (vb == 0xC4) { if (pos + 1 > len) return -1; blen = buf[pos]; pos += 1; }
        else if (vb == 0xC5) {
            if (pos + 2 > len) return -1;
            blen = ((int64_t)buf[pos] << 8) | buf[pos + 1]; pos += 2;
        } else if (vb == 0xC6) {
            if (pos + 4 > len) return -1;
            blen = ((int64_t)buf[pos] << 24) | ((int64_t)buf[pos+1] << 16) |
                   ((int64_t)buf[pos+2] << 8) | buf[pos+3]; pos += 4;
        } else return -4;
        if (pos + blen > len) return -1;
        const uint8_t* blob = buf + pos;
        // roaring: accept only the no-run cookie; run containers -> Python
        if (blen < 8) return -5;
        uint32_t cookie = blob[0] | (blob[1] << 8) | (blob[2] << 16) |
                          ((uint32_t)blob[3] << 24);
        if ((cookie & 0xFFFF) == 12347) return -6;
        if (cookie != 12346) return -5;
        int64_t nc = blob[4] | (blob[5] << 8) | (blob[6] << 16) |
                     ((int64_t)blob[7] << 24);
        int64_t dpos = 8 + 4 * nc + 4 * nc;  // skip descriptors + offsets
        const uint8_t* desc = blob + 8;
        for (int64_t c = 0; c < nc; c++) {
            uint32_t key = desc[0] | (desc[1] << 8);
            int64_t card = (int64_t)(desc[2] | (desc[3] << 8)) + 1;
            desc += 4;
            if (card <= 4096) {
                if (dpos + card * 2 > blen || no + card > out_cap) return -1;
                for (int64_t t = 0; t < card; t++) {
                    uint32_t lo = blob[dpos] | (blob[dpos + 1] << 8);
                    dpos += 2;
                    members[no] = (key << 16) | lo;
                    signs[no] = (uint16_t)sign;
                    no++;
                }
            } else {
                if (dpos + 8192 > blen) return -1;
                for (int64_t w = 0; w < 8192; w++) {
                    uint8_t byte = blob[dpos + w];
                    while (byte) {
                        int bit = __builtin_ctz(byte);
                        byte &= byte - 1;
                        if (no >= out_cap) return -1;
                        members[no] = (key << 16) | (uint32_t)(w * 8 + bit);
                        signs[no] = (uint16_t)sign;
                        no++;
                    }
                }
                dpos += 8192;
            }
        }
        pos += blen;
    }
    *n_out = no;
    return pos;
}

}  // extern "C"
