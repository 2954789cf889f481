// Native host-side post-processing for pywfa_tpu_torch (the port's own copy
// of pywfa_tpu/native/wfa_native.cpp).
//
// The device engine emits, per pair, a reversed stream of {X,I,D} walk ops plus
// a start diagonal; expanding that into the final per-base CIGAR requires a
// greedy match-fill against the sequences (the host half of the traceback,
// analogous to WFA2-lib's pcigar unpack re-deriving matches by comparing
// sequences). At batch 4096 this is the host hot loop, so it lives in C++
// with a C ABI consumed via ctypes. Run-length encoding of op strings into
// (op, len) CIGAR tuples is here too.
//
// Build: pywfa_tpu_torch/native/__init__.py runs g++ at first use
// (-O3 -shared -fPIC) into build/pywfa_tpu_torch/.

#include <cstdint>
#include <cstring>

#include <thread>

namespace {

// walk op stream encoding (must match pywfa_tpu_torch/ops/config.py WOP_*)
constexpr uint8_t WOP_X = 1;
constexpr uint8_t WOP_I = 2;
constexpr uint8_t WOP_D = 3;
constexpr uint8_t WOP_MFLAG = 4;

// numeric CIGAR op codes (pysam convention, align.pyx codes LUT)
constexpr uint8_t OP_M = 0;
constexpr uint8_t OP_I = 1;
constexpr uint8_t OP_D = 2;
constexpr uint8_t OP_X = 8;

inline bool chars_match(uint8_t a, uint8_t b, int wildcard) {
    if (a == b) return true;
    if (wildcard >= 0 &&
        (a == static_cast<uint8_t>(wildcard) ||
         b == static_cast<uint8_t>(wildcard)))
        return true;
    return false;
}

// Length of the common prefix of a[0..n) and b[0..n), word-at-a-time:
// XOR 8 bytes, count trailing zero bytes of the first nonzero word (the
// same blockwise-compare idea as the reference's AVX extend kernels,
// wavefront_extend_kernels.c:64-88, expressed portably).
inline int64_t common_prefix(const uint8_t* a, const uint8_t* b, int64_t n) {
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t wa, wb;
        memcpy(&wa, a + i, 8);
        memcpy(&wb, b + i, 8);
        const uint64_t x = wa ^ wb;
        if (x) return i + (__builtin_ctzll(x) >> 3);
    }
    for (; i < n; ++i)
        if (a[i] != b[i]) break;
    return i;
}

}  // namespace

extern "C" {

// Bumped on every exported-signature change; the loader refuses a .so
// whose version doesn't match (a stale binary with make unavailable
// would otherwise be called with a shifted argument list).
int64_t wfa_abi_version() { return 3; }

// Scatter concatenated sequence bytes into a sentinel-padded token matrix
// and (optionally) 2-bit pack the same rows in one pass -- the host
// encode work of one dispatch (batch.encode_batch + wfa_pack2_batch
// fused; numpy fancy-index scatter costs ~8 ms at B=4096, this is <1 ms).
//
//   flat:       concatenated sequence bytes (sum(lens))
//   lens:       [B] per-sequence lengths
//   out_tokens: [B, stride], filled with `sentinel` past each length
//   out_packed: [B, Wout] 2-bit codes (LSB-first), or Wout == 0 to skip
//
// Returns 0 when packing succeeded, 1 when any in-length byte was not
// uppercase ACGT (tokens are still valid; packed content is undefined).
int64_t wfa_encode_pack_batch(
    const uint8_t* flat, const int64_t* lens, int64_t B, int64_t stride,
    uint8_t sentinel, uint8_t* out_tokens,
    uint8_t* out_packed, int64_t Wout) {
    uint8_t code[256];
    memset(code, 255, sizeof(code));
    code['A'] = 0;
    code['C'] = 1;
    code['G'] = 2;
    code['T'] = 3;
    int64_t rc = 0;
    int64_t off = 0;
    for (int64_t b = 0; b < B; ++b) {
        const int64_t n = lens[b] < stride ? lens[b] : stride;
        const uint8_t* src = flat + off;
        uint8_t* row = out_tokens + b * stride;
        memcpy(row, src, n);
        memset(row + n, sentinel, stride - n);
        if (Wout > 0 && rc == 0) {
            uint8_t* orow = out_packed + b * Wout;
            uint8_t acc = 0;
            // Wout may cover less than the token stride (the caller
            // skips the chunk tail); a row longer than the packed
            // capacity violates the lens<=pack_width precondition --
            // FAIL the pack (caller falls back to the raw-token push)
            // rather than silently truncate to a corrupted sequence
            if (n > 4 * Wout) {
                rc = 1;
                off += lens[b];
                continue;
            }
            int64_t j = 0;
            for (; j < n; ++j) {
                const uint8_t c = code[src[j]];
                if (c == 255) {
                    rc = 1;
                    break;
                }
                acc |= static_cast<uint8_t>(c << ((j & 3) * 2));
                if ((j & 3) == 3) {
                    orow[j >> 2] = acc;
                    acc = 0;
                }
            }
            if (rc == 0) {
                if (j & 3) orow[j >> 2] = acc;
                for (int64_t k = (j + 3) >> 2; k < Wout; ++k) orow[k] = 0;
            }
        }
        off += lens[b];
    }
    return rc;
}

// Expand one pair's reversed walk-op stream into per-base numeric ops.
//
//   ops_fwd:  [stride] uint8 forward-order sparse op stream (scan n_ops entries)
//   out:      caller buffer of capacity out_cap (>= plen + tlen)
//
// Returns the number of per-base ops written, or -1 on overflow/error.
int64_t wfa_match_fill(
    const uint8_t* ops_fwd, int64_t n_ops, int64_t k_start,
    const uint8_t* pattern, int64_t plen,
    const uint8_t* text, int64_t tlen,
    int32_t wildcard,
    int64_t trail_i, int64_t trail_d,  // trailing free I/D counts
    int64_t cap_h,  // >=0: FORCE the final run to (cap_h - h) 'M' ops
                    // (dropped-pair walks; see batch._match_fill docstring)
    uint8_t* out, int64_t out_cap) {
    int64_t v, h;
    if (k_start >= 0) {
        v = 0;
        h = k_start;
    } else {
        v = -k_start;
        h = 0;
    }
    int64_t n = 0;
    // leading free indels (reference: wavefront_backtrace.c:514-516)
    for (int64_t i = 0; i < h && n < out_cap; ++i) out[n++] = OP_I;
    for (int64_t i = 0; i < v && n < out_cap; ++i) out[n++] = OP_D;

    auto extend = [&](bool final) {
        if (final && cap_h >= 0) {
            // forced fill to the recorded end offset, no equality check
            // (reference: wavefront_backtrace.c:425-436)
            for (; h < cap_h; ++v, ++h) {
                if (n >= out_cap) return false;
                out[n++] = OP_M;
            }
            return true;
        }
        const int64_t lim = plen - v < tlen - h ? plen - v : tlen - h;
        int64_t run;
        if (wildcard < 0) {
            run = common_prefix(pattern + v, text + h, lim);
        } else {
            for (run = 0; run < lim &&
                          chars_match(pattern[v + run], text[h + run],
                                      wildcard);
                 ++run) {}
        }
        if (n + run > out_cap) return false;
        memset(out + n, OP_M, run);
        n += run;
        v += run;
        h += run;
        return true;
    };

    int64_t last_i = -1;
    for (int64_t i = 0; i < n_ops; ++i)
        if (ops_fwd[i] != 0) last_i = i;

    if (!extend(last_i < 0)) return -1;
    // ops stream is forward-order and zero-sparse (0 = no op at a level)
    for (int64_t i = 0; i < n_ops; ++i) {
        const uint8_t tok = ops_fwd[i];
        if (tok == 0) continue;
        const uint8_t op = tok & 3;
        if (n >= out_cap) return -1;
        switch (op) {
            case WOP_X:
                out[n++] = OP_X;
                ++v;
                ++h;
                break;
            case WOP_I:
                out[n++] = OP_I;
                ++h;
                break;
            case WOP_D:
                out[n++] = OP_D;
                ++v;
                break;
            default:
                return -1;
        }
        if (tok & WOP_MFLAG) {
            if (!extend(i == last_i)) return -1;
        }
    }
    // trailing free indels, I-block then D-block
    for (int64_t i = 0; i < trail_i && n < out_cap; ++i) out[n++] = OP_I;
    for (int64_t i = 0; i < trail_d && n < out_cap; ++i) out[n++] = OP_D;
    return n;
}

// Batched variant over B pairs with flat, padded arrays.
//
//   ops_fwd:   [B, ops_stride] uint8
//   pat/txt:   [B, pat_stride] / [B, txt_stride] uint8 (row-major, padded)
//   out:       [B, out_stride] uint8 ASCII op chars (M/I/D/X);
//   out_lens:  [B] int64
//
// Pairs with n_ops[b] < 0 are skipped (out_lens[b] = -1).
void wfa_match_fill_batch(
    const uint8_t* ops_fwd, int64_t ops_stride,
    const int64_t* n_ops, const int64_t* k_start,
    const uint8_t* pat, int64_t pat_stride, const int64_t* plens,
    const uint8_t* txt, int64_t txt_stride, const int64_t* tlens,
    const int64_t* trail_i, const int64_t* trail_d,
    const int64_t* cap_h,  // per pair; -1 = no cap (clean completion)
    int32_t wildcard, int64_t B,
    uint8_t* out, int64_t out_stride, int64_t* out_lens) {
    uint8_t ascii[256];
    memset(ascii, '?', sizeof(ascii));
    ascii[OP_M] = 'M';
    ascii[OP_I] = 'I';
    ascii[OP_D] = 'D';
    ascii[OP_X] = 'X';
    auto fill_range = [&](int64_t b0, int64_t b1) {
        for (int64_t b = b0; b < b1; ++b) {
            if (n_ops[b] < 0) {
                out_lens[b] = -1;
                continue;
            }
            uint8_t* row = out + b * out_stride;
            const int64_t n = wfa_match_fill(
                ops_fwd + b * ops_stride, n_ops[b], k_start[b],
                pat + b * pat_stride, plens[b],
                txt + b * txt_stride, tlens[b],
                wildcard, trail_i[b], trail_d[b], cap_h[b],
                row, out_stride);
            out_lens[b] = n;
            for (int64_t i = 0; i < n; ++i) row[i] = ascii[row[i]];
        }
    };
    // split across hardware threads (the ctypes caller released the GIL,
    // so these run alongside the Python host pipeline); small batches
    // aren't worth the spawn cost
    unsigned hw = std::thread::hardware_concurrency();
    const int64_t nthreads =
        (B >= 512 && hw >= 2) ? (hw < 4 ? hw : 4) : 1;
    if (nthreads == 1) {
        fill_range(0, B);
        return;
    }
    std::thread workers[4];
    const int64_t step = (B + nthreads - 1) / nthreads;
    for (int64_t t = 1; t < nthreads; ++t) {
        const int64_t b0 = t * step;
        const int64_t b1 = b0 + step < B ? b0 + step : B;
        if (b0 < b1) workers[t] = std::thread(fill_range, b0, b1);
    }
    fill_range(0, step < B ? step : B);
    for (int64_t t = 1; t < nthreads; ++t)
        if (workers[t].joinable()) workers[t].join();
}

// Pack a [B, Wm] token matrix into fused 2-bit rows [B, ceil(Wm/4)]
// (A=0, C=1, G=2, T=3, LSB-first -- the layout engine._decode_packed
// expects). Bytes past lens[b] pack as 0. Returns 0, or -1 when any
// in-length byte is not uppercase ACGT (caller falls back to raw tokens).
int64_t wfa_pack2_batch(const uint8_t* mat, int64_t B, int64_t Wm,
                        const int64_t* lens, uint8_t* out, int64_t Wout) {
    uint8_t code[256];
    memset(code, 255, sizeof(code));
    code['A'] = 0;
    code['C'] = 1;
    code['G'] = 2;
    code['T'] = 3;
    for (int64_t b = 0; b < B; ++b) {
        const uint8_t* row = mat + b * Wm;
        uint8_t* orow = out + b * Wout;
        const int64_t n = lens[b] < Wm ? lens[b] : Wm;
        // lens<=pack_width precondition violated: fail the whole pack
        // (caller falls back to the raw-token push) instead of silently
        // truncating to a corrupted sequence
        if (n > 4 * Wout) return -1;
        uint8_t acc = 0;
        int64_t j = 0;
        for (; j < n; ++j) {
            const uint8_t c = code[row[j]];
            if (c == 255) return -1;
            acc |= static_cast<uint8_t>(c << ((j & 3) * 2));
            if ((j & 3) == 3) {
                orow[j >> 2] = acc;
                acc = 0;
            }
        }
        if (j & 3) orow[j >> 2] = acc;
        for (int64_t k = (j + 3) >> 2; k < Wout; ++k) orow[k] = 0;
    }
    return 0;
}

// Run-length encode a per-base numeric op row into (op, len) pairs.
// Returns the number of tuples, or -1 if out capacity exceeded.
int64_t wfa_rle(const uint8_t* ops, int64_t n,
                int32_t* out_ops, int32_t* out_lens, int64_t out_cap) {
    if (n <= 0) return 0;
    int64_t m = 0;
    uint8_t last = ops[0];
    int32_t run = 1;
    for (int64_t i = 1; i < n; ++i) {
        if (ops[i] == last) {
            ++run;
        } else {
            if (m >= out_cap) return -1;
            out_ops[m] = last;
            out_lens[m] = run;
            ++m;
            last = ops[i];
            run = 1;
        }
    }
    if (m >= out_cap) return -1;
    out_ops[m] = last;
    out_lens[m] = run;
    return m + 1;
}

}  // extern "C"
