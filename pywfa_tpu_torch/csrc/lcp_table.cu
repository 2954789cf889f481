// Per-diagonal run-length table for Hopper (sm_90a), h-major:
//
//   R[h, b, w] = the number of consecutive matches along diagonal
//   k = kmin + w starting at text position h, comparing pattern[h - k + j]
//   with text[h + j],
//
// by the backward scan r(h) = eq(h) ? r(h + 1) + 1 : 0. The rows are
// padded with distinct sentinels (pattern 1, text 2) and a pattern index
// outside the row reads the pattern's sentinel, so a run ends at either
// sequence's end by itself. A wildcard byte matches any real character on
// either side and never a sentinel. The bytes are compared as bytes, as
// the plain version compares int8 tokens.
//
// Replaces pywfa_tpu/ops/pallas/lcp_table.py::_kernel and its
// pallas_call in build_lcp_table_hmajor. The plain torch version of the
// same function is
// pywfa_tpu_torch/ops/lcp_table.py::build_lcp_table_hmajor_ref; both give
// the same bytes. With the table the fused score loop (csrc/fused_loop.cu)
// extends a cell with one load, off += R[off, b, w].
//
// What bounds it: bytes, its output ([Ltp, B, W] elements, each written
// once; the two rows it reads are thousands of times smaller). A design
// that spends a loop iteration and a narrow store on every cell runs at
// the rate of cells, well under the rate of bytes for a one-byte table.
// So a thread owns `cells` adjacent diagonals (b, w0 .. w0 + cells - 1)
// and holds them four to a 32-bit word, one byte lane a diagonal (SWAR):
//
// - The pattern window slides in registers. At text position h, lane i
//   reads pattern[jtop - t - i] (t = Ltp - 1 - h, jtop its index for lane
//   0 at the top): a window over the pattern row read backwards. The
//   thread keeps that reversed stream as cells / 4 + 1 words; step r of
//   four takes each window word with one funnel shift by r bytes, and
//   every four steps the stream moves one word and one new word comes in.
//   A word comes from the two aligned words it spans (loaded only where
//   they hold a byte of the row), one funnel shift by the thread's fixed
//   misalignment and one byte mask that puts the sentinel in for the
//   bytes outside the row: the same instructions for every thread, no
//   branch. The rows are read from device memory through the read-only
//   path, the words of the next 16 text positions (four text words, four
//   stream words) while the thread works through the current 16, so
//   their latency hides behind those steps; nothing is staged in shared
//   memory, so a pattern row has no length limit.
// - The compare of four lanes is four word operations: the zero bytes of
//   pattern ^ text (the text byte broadcast to four lanes by one byte
//   permutation) flag their lanes in bit 7, and one byte permutation that
//   replicates each lane's bit 7 gives the lane mask. The runs step as
//   run = (run + 0x01010101) & mask: a run never passes Ltp, below 256 in
//   a byte table, so no carry crosses a lane. An int16 table widens the
//   mask to two 16-bit lanes a word (two more permutations) and steps
//   by 0x00010001.
// - The cells a thread owns at h are one store of 4 * kNB elements, 16
//   bytes at the most diagonals a thread, where W is a multiple of them
//   (it is on the paths: a band is a multiple of 128); else every thread
//   stores its cells inside W byte by byte. Neighbouring threads own
//   neighbouring groups, and pair b + 1's row follows pair b's, so a
//   warp's stores at h are one contiguous run of up to 512 bytes. The
//   stores are streaming (st.global.cs): the table is read back only
//   after the kernel, and without the hint the card's writes reach 83% of
//   its bytes rate, with it 88-91% (measured).
// - A 1-D grid of threads over (pair, group of diagonals, segment), with
//   size_t indices: no grid dimension is B, so any batch launches. On a
//   small batch a thread's walk down the rows, not the card's bytes,
//   bounds the time, so the rows are cut into `segments` slices, a thread
//   each, neighbouring lanes of one warp: each scans its slice from runs
//   of 0, takes from the lanes above it (shuffles) the runs at the bottom
//   of the slices above, and carries the true run into its own slice,
//   storing again only its top rows, as far as a lane whose carried run
//   is not 0 goes on matching. The wrapper (ops/lcp_table.py::
//   launch_shape) picks `cells` and `segments` from the batch, then the
//   block and grid.
//
// Nothing of the TPU program's flipped pattern row, 128-position blocks,
// descending grid or scratch carry is carried over: those answer that
// machine's alignment rules and its sequential grid.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPatternPad4 = 0x01010101u;
constexpr uint32_t kTextPad4 = 0x02020202u;
constexpr int kTextPad = 2;
constexpr int kMaxThreads = 256;

// prmt.b32 with a selector whose nibbles may set bit 3: that byte of the
// result is then bit 7 of the selected byte, replicated (PTX ISA, prmt)
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(0u), "r"(sel));
  return r;
}

// bit 7 of byte i set where byte i of a equals byte i of b (the other bits
// are not meaningful)
__device__ __forceinline__ uint32_t eq_flags(uint32_t a, uint32_t b) {
  const uint32_t x = a ^ b;
  return ~(((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x);
}

// A row read backwards four bytes at a time: word n holds row[lo0 - 4n ..
// lo0 - 4n + 3], byte r = row[lo0 - 4n + r], or pad4's byte where that
// index lies outside [0, len). In two halves, so that a load's latency
// hides behind the work between them: fetch(n) loads the two aligned
// words the four bytes span, each only where it holds a byte of the row
// (so no load lies past the row's allocation); take(n) shifts the bytes
// into place (the same shift for every n) and puts the pads in with one
// byte mask. The same instructions for every n and row length: no branch.
struct Words {
  uint32_t lo, hi;
};

struct Stream {
  const uint32_t* base;  // the aligned word that holds row[lo0]
  int off0;              // its first byte's index in the row
  int lo0, len;
  uint32_t sh, pad4;

  __device__ __forceinline__ Stream(const int8_t* row, int lo0_, int len_,
                                    uint32_t pad4_)
      : lo0(lo0_), len(len_), pad4(pad4_) {
    const uintptr_t at = reinterpret_cast<uintptr_t>(row) +
                         static_cast<uintptr_t>(static_cast<intptr_t>(lo0));
    base = reinterpret_cast<const uint32_t*>(at & ~static_cast<uintptr_t>(3));
    sh = static_cast<uint32_t>(at & 3) * 8;
    off0 = lo0 - static_cast<int>(at & 3);
  }

  // whether the aligned word at index o of the row holds a byte of it
  __device__ __forceinline__ bool holds(int o) const {
    return static_cast<unsigned>(o + 3) < static_cast<unsigned>(len + 3);
  }

  __device__ __forceinline__ Words fetch(int n) const {
    const int o = off0 - 4 * n;
    return {holds(o) ? __ldg(base - n) : 0u,
            holds(o + 4) ? __ldg(base - n + 1) : 0u};
  }

  __device__ __forceinline__ uint32_t take(Words w, int n) const {
    const int lo = lo0 - 4 * n;
    const uint32_t v = __funnelshift_r(w.lo, w.hi, sh);
    // the bytes inside the row: from byte `below` to 3 - `past`
    const uint32_t below = 8 * static_cast<uint32_t>(min(max(-lo, 0), 4));
    const uint32_t past =
        8 * static_cast<uint32_t>(min(max(lo + 4 - len, 0), 4));
    const uint32_t keep = __funnelshift_lc(0u, ~0u, below) &
                          __funnelshift_rc(~0u, 0u, past);
    return (v & keep) | (pad4 & ~keep);
  }
};

// lane masks of a word of runs: 0xFF.. in every lane (a byte for a uint8
// table, 16 bits for int16) where a's lane equals b's
template <typename OutT>
__device__ __forceinline__ uint32_t lanes_eq(uint32_t a, uint32_t b) {
  if (sizeof(OutT) == 1) return prmt(eq_flags(a, b), 0xBA98u);
  const uint32_t x = a ^ b;
  return prmt(~(((x & 0x7FFF7FFFu) + 0x7FFF7FFFu) | x), 0xBB99u);
}

// One step at text position top - r of a group: compare the window (the
// pattern stream's words win[0 .. kNB], shifted by r bytes) with the text
// byte t4s's byte 3 - r, step the runs, store them, move o one row down.
// kFull: every thread's cells lie inside W and the table is aligned for
// one store of them (up to 16 bytes); else the cells inside W (`valid`
// bytes) are stored byte by byte. kTrack: clear in `alive` the lanes that
// do not match.
template <typename OutT, int kNB, bool kWild, bool kFull, bool kTrack>
__device__ __forceinline__ void step(
    const uint32_t (&win)[kNB + 1], uint32_t t4s, int r, uint32_t wild4,
    uint32_t (&run)[kNB * sizeof(OutT)],
    uint32_t (&alive)[kNB * sizeof(OutT)], uint8_t*& o, size_t row_bytes,
    int valid) {
  constexpr int kWords = kNB * static_cast<int>(sizeof(OutT));
  const uint32_t t4 = __byte_perm(t4s, 0u, 0x1111u * (3 - r));
  uint32_t t_wild = 0, t_real = ~0u;
  if (kWild) {
    const uint32_t t = t4 & 0xFFu;
    t_wild = t == (wild4 & 0xFFu) ? ~0u : 0u;
    t_real = t == kTextPad ? 0u : ~0u;
  }
#pragma unroll
  for (int q = 0; q < kNB; ++q) {
    const uint32_t p4 =
        r == 0 ? win[q] : __funnelshift_r(win[q], win[q + 1], 8 * r);
    uint32_t e = eq_flags(p4, t4);
    if (kWild) {
      e = (e | eq_flags(p4, wild4) | t_wild) & ~eq_flags(p4, kPatternPad4) &
          t_real;
    }
    if (sizeof(OutT) == 1) {
      const uint32_t m = prmt(e, 0xBA98u);
      run[q] = (run[q] + 0x01010101u) & m;
      if (kTrack) alive[q] &= m;
    } else {
      const uint32_t m0 = prmt(e, 0x9988u), m1 = prmt(e, 0xBBAAu);
      run[2 * q] = (run[2 * q] + 0x00010001u) & m0;
      run[2 * q + 1] = (run[2 * q + 1] + 0x00010001u) & m1;
      if (kTrack) {
        alive[2 * q] &= m0;
        alive[2 * q + 1] &= m1;
      }
    }
  }
  if (kFull) {
    if (kWords % 4 == 0) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        __stcs(reinterpret_cast<uint4*>(o) + i,
               make_uint4(run[4 * i], run[4 * i + 1], run[4 * i + 2],
                          run[4 * i + 3]));
      }
    } else if (kWords == 2) {
      __stcs(reinterpret_cast<uint2*>(o), make_uint2(run[0], run[1]));
    } else {
      __stcs(reinterpret_cast<unsigned int*>(o), run[0]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4 * kWords; ++i) {
      if (i < valid) o[i] = static_cast<uint8_t>(run[i / 4] >> (8 * (i % 4)));
    }
  }
  o -= row_bytes;
}

// What a thread's scan reads and writes: the text row from txt[hi]
// down, the pattern row from jtop (the pattern index of lane 0 at h = hi)
// down, the table's cells (hi, b, w0 ..)
struct Lane {
  Stream text, pattern;
  uint8_t* o;  // the thread's cells at h = hi
  size_t row_bytes;
  int valid;
  uint32_t wild4;
};

// the pattern stream's word n reversed, so that byte 0 holds the highest
// index: the window of lanes 0-3 at the n-th position from the top
__device__ __forceinline__ uint32_t reversed(uint32_t v) {
  return __byte_perm(v, 0u, 0x0123u);
}

// The scan of text positions hi down to lo from `run` (the runs at
// hi + 1), storing every row; leaves in `run` the runs at lo. In blocks of
// 16 text positions: the words a block needs (txt[top - 4g - 3 .. top - 4g]
// and the stream words n + g, shifted in after each group g of four steps)
// are fetched at the start of the block before and taken at the start of
// their own, so their latency hides behind 16 steps. kTrack: `run` holds
// the true runs carried into a segment from above; stop after the block
// in which the last lane whose carried run was nonzero stops matching
// (below it the runs are those the scan from 0 stored).
template <typename OutT, int kNB, bool kWild, bool kFull, bool kTrack>
__device__ __forceinline__ void scan(Lane l, int hi, int lo,
                                     uint32_t (&run)[kNB * sizeof(OutT)]) {
  constexpr int kWords = kNB * static_cast<int>(sizeof(OutT));
  uint32_t alive[kWords];
  if (kTrack) {
    uint32_t any = 0;
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      alive[i] = ~lanes_eq<OutT>(run[i], 0u);
      any |= alive[i];
    }
    if (any == 0) return;
  }
  uint32_t win[kNB + 1];
#pragma unroll
  for (int q = 0; q <= kNB; ++q) {
    win[q] = reversed(l.pattern.take(l.pattern.fetch(q), q));
  }
  // text words m, pattern words n of the next block
  Words tw[4], pw[4];
  int m = 0, n = kNB + 1;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    tw[g] = l.text.fetch(m + g);
    pw[g] = l.pattern.fetch(n + g);
  }
  for (int top = hi; top >= lo; top -= 16, m += 4, n += 4) {
    uint32_t tq[4], pq[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      tq[g] = l.text.take(tw[g], m + g);
      pq[g] = reversed(l.pattern.take(pw[g], n + g));
      tw[g] = l.text.fetch(m + g + 4);
      pw[g] = l.pattern.fetch(n + g + 4);
    }
    if (top - lo >= 15) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          step<OutT, kNB, kWild, kFull, kTrack>(win, tq[g], r, l.wild4, run,
                                                alive, l.o, l.row_bytes,
                                                l.valid);
        }
#pragma unroll
        for (int q = 0; q < kNB; ++q) win[q] = win[q + 1];
        win[kNB] = pq[g];
      }
    } else {
      // the last block, of top - lo + 1 < 16 steps
#pragma unroll
      for (int g = 0; g < 4; ++g) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (4 * g + r <= top - lo) {
            step<OutT, kNB, kWild, kFull, kTrack>(win, tq[g], r, l.wild4,
                                                  run, alive, l.o,
                                                  l.row_bytes, l.valid);
          }
        }
#pragma unroll
        for (int q = 0; q < kNB; ++q) win[q] = win[q + 1];
        win[kNB] = pq[g];
      }
    }
    if (kTrack) {
      uint32_t any = 0;
#pragma unroll
      for (int i = 0; i < kWords; ++i) any |= alive[i];
      if (any == 0) return;
    }
  }
}

// One thread a group of 4 * kNB diagonals of one pair and a segment of the
// text positions: the `segments` threads of a group are neighbouring lanes
// of a warp, segment 0 the top ceil(Ltp / segments) positions. Each scans
// its segment from runs of 0, then takes from its warp the runs at the
// bottom of the segments above to carry the true run into its own (a run
// that spans a whole segment passes the carry on), and stores again the
// top rows that the carry reaches. groups = ceil(W / cells) groups a pair.
template <typename OutT, int kNB, bool kWild, bool kFull>
__global__ void __launch_bounds__(kMaxThreads)
    lcp_table(const int8_t* __restrict__ pat, const int8_t* __restrict__ txt,
              OutT* __restrict__ out, int B, int W, int Lpp, int Ltp,
              int kmin, uint32_t wild4, int groups, int segments) {
  constexpr int kCells = 4 * kNB;
  constexpr int kWords = kNB * static_cast<int>(sizeof(OutT));
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  const size_t item = tid / segments;
  if (item >= static_cast<size_t>(B) * groups) return;
  const int seg = static_cast<int>(tid % segments);
  const int b = static_cast<int>(item / groups);
  const int w0 =
      static_cast<int>(item - static_cast<size_t>(b) * groups) * kCells;
  const int seglen = (Ltp + segments - 1) / segments;
  const int hi = Ltp - 1 - seg * seglen;
  const int lo = max(0, hi - seglen + 1);
  const size_t BW = static_cast<size_t>(B) * W;
  // (the streams of an empty segment, hi < 0, are never read)
  Lane l{Stream(txt + static_cast<size_t>(b) * Ltp, hi - 3, Ltp, kTextPad4),
         Stream(pat + static_cast<size_t>(b) * Lpp, hi - kmin - w0 - 3, Lpp,
                kPatternPad4)};
  l.o = reinterpret_cast<uint8_t*>(
      out + (static_cast<size_t>(max(hi, 0)) * BW +
             static_cast<size_t>(b) * W + w0));
  l.row_bytes = BW * sizeof(OutT);
  l.valid = min(kCells, W - w0) * static_cast<int>(sizeof(OutT));
  l.wild4 = wild4;
  uint32_t run[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) run[i] = 0;
  if (hi >= 0) scan<OutT, kNB, kWild, kFull, false>(l, hi, lo, run);
  if (segments == 1) return;
  // the true run at hi + 1: over the segments above, top down, a segment's
  // bottom run, plus the carry where that run spans the whole segment
  const int first = static_cast<int>(threadIdx.x & 31) & ~(segments - 1);
  const unsigned mask = ((1u << segments) - 1) << first;
  uint32_t carry[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) carry[i] = 0;
  for (int k = 0; k < segments; ++k) {
    const int top_k = Ltp - 1 - k * seglen;
    const uint32_t len_k = static_cast<uint32_t>(
        top_k < 0 ? 0 : min(seglen, top_k + 1));
    const uint32_t len = len_k * (sizeof(OutT) == 1 ? 0x01010101u
                                                    : 0x00010001u);
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const uint32_t bottom = __shfl_sync(mask, run[i], first + k);
      if (k < seg) {
        carry[i] = bottom + (carry[i] & lanes_eq<OutT>(bottom, len));
      }
    }
  }
  if (hi >= 0) {
    l.o = reinterpret_cast<uint8_t*>(
        out + (static_cast<size_t>(hi) * BW + static_cast<size_t>(b) * W +
               w0));
    scan<OutT, kNB, kWild, kFull, true>(l, hi, lo, carry);
  }
}

template <typename OutT, int kNB, bool kFull>
void launch(const int8_t* pat, const int8_t* txt, void* out, int B, int W,
            int Lpp, int Ltp, int kmin, int wildcard, int groups,
            int segments, int threads, int blocks, cudaStream_t st) {
  OutT* o = static_cast<OutT*>(out);
  if (wildcard >= 0) {
    const uint32_t wild4 = 0x01010101u * static_cast<uint32_t>(wildcard);
    lcp_table<OutT, kNB, true, kFull><<<blocks, threads, 0, st>>>(
        pat, txt, o, B, W, Lpp, Ltp, kmin, wild4, groups, segments);
  } else {
    lcp_table<OutT, kNB, false, kFull><<<blocks, threads, 0, st>>>(
        pat, txt, o, B, W, Lpp, Ltp, kmin, 0u, groups, segments);
  }
}

template <typename OutT, int kNB>
void launch(bool full, const int8_t* pat, const int8_t* txt, void* out,
            int B, int W, int Lpp, int Ltp, int kmin, int wildcard,
            int groups, int segments, int threads, int blocks,
            cudaStream_t st) {
  if (full) {
    launch<OutT, kNB, true>(pat, txt, out, B, W, Lpp, Ltp, kmin, wildcard,
                            groups, segments, threads, blocks, st);
  } else {
    launch<OutT, kNB, false>(pat, txt, out, B, W, Lpp, Ltp, kmin, wildcard,
                             groups, segments, threads, blocks, st);
  }
}

}  // namespace

extern "C" {

// Build R[Ltp, B, W] on `stream` from pat [B, Lpp] and txt [B, Ltp] int8
// rows; `out` holds uint8 when out_u8 (runs must fit: Ltp < 256) else
// int16 (Ltp < 32768). The launch: `cells` diagonals a thread (4 or 16
// for uint8, 4 for int16), `segments` threads a group of them (1, 2,
// 4 or 8, each a slice of the text positions), `threads` a block (whole
// warps, at most 256), `blocks` blocks, which must cover B * ceil(W /
// cells) * segments threads. wildcard: a byte 0-255, or -1. Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for what
// it does not take). All pointers are device pointers.
int wfa_lcp_table(const void* pat, const void* txt, void* out, int B, int W,
                  int Lpp, int Ltp, int kmin, int wildcard, int out_u8,
                  int cells, int segments, int threads, int blocks,
                  void* stream) {
  if (B < 0 || W < 0 || Ltp < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || W == 0 || Ltp == 0) return 0;
  const bool cells_ok = cells == 4 || (out_u8 && cells == 16);
  const int groups = cells_ok ? (W + cells - 1) / cells : 0;
  if (pat == nullptr || txt == nullptr || out == nullptr || Lpp < 0 ||
      Ltp >= (out_u8 ? 256 : 32768) || wildcard > 255 || !cells_ok ||
      (segments != 1 && segments != 2 && segments != 4 && segments != 8) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      blocks < 1 ||
      static_cast<long long>(blocks) * threads <
          static_cast<long long>(B) * groups * segments) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // one store of a thread's cells where every group lies inside W and the
  // pointer and a pair's row of W elements are aligned to that store
  const size_t bytes = static_cast<size_t>(cells) * (out_u8 ? 1 : 2);
  const bool full =
      W % cells == 0 && reinterpret_cast<uintptr_t>(out) % bytes == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(pat);
  const int8_t* t = static_cast<const int8_t*>(txt);
  const int wc = wildcard < 0 ? -1 : wildcard;
  if (out_u8) {
    if (cells == 16) {
      launch<uint8_t, 4>(full, p, t, out, B, W, Lpp, Ltp, kmin, wc, groups,
                         segments, threads, blocks, st);
    } else {
      launch<uint8_t, 1>(full, p, t, out, B, W, Lpp, Ltp, kmin, wc, groups,
                         segments, threads, blocks, st);
    }
  } else {
    launch<int16_t, 1>(full, p, t, out, B, W, Lpp, Ltp, kmin, wc, groups,
                       segments, threads, blocks, st);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* wfa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
