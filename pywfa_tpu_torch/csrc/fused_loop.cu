// Fused whole-alignment WFA score loop for Hopper (sm_90a): all five
// distance metrics (gap-affine, gap-affine 2-piece, gap-linear, edit,
// indel), end-to-end or ends-free span (with a match bonus too: the
// boundary is then seeded at every score divisible by -match), full-CIGAR
// choice recording or score only, and the heuristic cascade (wf-adaptive,
// wfmash, x-drop, z-drop, banded static and adaptive); one shot from score
// 0, or one segment of a segmented run that loads and stores its state;
// bands of any width; extension by the packed equality words, by the
// run-length table of csrc/lcp_table.cu, or by comparing the token rows in
// place.
//
// Replaces pywfa_tpu/ops/pallas/fused_loop.py::_kernel (:197; every
// metric's branch, the heuristic cascade and the ends-free match seeding)
// and both of its pallas_calls: the recording one (:900) and the
// score-only one (:919). The plain torch
// version of the same program is
// pywfa_tpu_torch/ops/fused_loop.py::align_batch_fused_loop_ref; both
// produce byte-identical status, final_s, end_k, end_off and choices.
//
// Design: every variant is built as four kernels, and the caller names
// the one a launch takes (pywfa_tpu_torch/ops/fused_loop.py::kernel_build);
// a launch that build cannot take fails, nothing falls back.
//
// - The group build (fused_loop_group, group_pair): G warps a pair (G from
//   1 to 8, pywfa_tpu_torch/ops/fused_loop.py::group_size, from the band
//   the rung's score cap allows and the pairs an SM holds), up to 8 pairs
//   a block at G == 1 and one at G > 1, a persistent grid whose groups take the next pair from a
//   counter. Every per-cell pass runs over the live band only, 32 * G
//   diagonals a stride, and folds its minima and maxima in registers,
//   one group reduction a pass: with G == 1 a __reduce_*_sync and a
//   __syncwarp, with G > 1 a warp reduction, one partial a warp in the
//   pair's shared memory and the pair's own named barrier, two a step (no
//   block barrier: a pair never waits on another's steps). It rests on one
//   invariant: every ring cell outside its row's band is NULL. It takes
//   any launch whose ring fits a group's share of the block (bands up to
//   1024 diagonals at pywfa's penalties): one shot or a segment (the ring,
//   its bands and the carry copied in with coalesced 16-byte loads and
//   out the same way), on the words, the table or the rows. Bounded by
//   the latency of a step: an extension load from global memory, then the
//   dependent folds, about 1.0 us at G == 1 and 1.2-1.5 at G > 1 (every
//   warp of a pair runs the step's uniform chain); a wide band takes
//   several warps so that a pass walks it in a few strides, a batch of
//   many pairs one warp.
// - The narrow build (loop_body, kBuildNarrow): one block a pair, a thread
//   a diagonal, the one-shot run on the words; each thread's cell of s + 1
//   waits in registers for the trim. It walks a band that fills W in one
//   pass with the leanest step of all (1.10 us at one pair an SM at
//   W = 384), and stays the build of the one-shot terminal rungs, where the
//   group build lost to it at every G (measured: PERF.md, kernel table).
//   Bounded by two to five __syncthreads a step over all W diagonals.
// - The cluster build (fused_loop_cluster, loop_body with kBuildCluster):
//   one pair on a thread-block cluster of C CTAs (launched with the
//   cluster dimension, C at most 8). CTA r owns the slice of diagonals
//   [r * W / C, (r + 1) * W / C), three a thread (the fastest of one to
//   four, measured), and that slice's columns of the ring in its own
//   shared memory, so a wide band keeps its ring out of global memory and
//   spreads over C SMs. A cell across a slice edge (the compute's k - 1 and
//   k + 1, the ends-free end cell, the cascade's sampled cells) is read
//   from the CTA that owns it through distributed shared memory, after the
//   cluster barrier that already separates the phases; end to end, the
//   thread that owns the end cell writes its test into every CTA before
//   that barrier instead.
//   Every block reduction becomes the cluster's: a warp reduction, the
//   warp's partial written into the row of every CTA (lanes 0..C-1 of the
//   warp, one CTA each), one cluster barrier, and a fold of the C * nwarps
//   partials in each CTA; a step takes two such barriers (after the
//   extension, after the compute), the cascade up to four more. Bounded by
//   the latency of the cluster barriers. A pair's CTAs leave together,
//   after a last cluster barrier, so none leaves while another may read
//   its shared memory.
// - The general build (fused_loop, loop_body with kBuildGeneral): one block
//   a pair, a thread owning the diagonals w = tid, tid + blockDim, ...; the
//   ring in shared memory, or in a global [B, rows, W] array that the L2
//   holds where it passes one block (gap-affine past W = 3840, the 2-piece
//   metric past W = 1600). It takes the bands of 1025 to 3072 diagonals
//   whose ring fits one block, two or three a thread (as fast as the
//   cluster build at W = 1792 and 2176, measured; at W = 3584 the cluster
//   build was 1.2x faster), and a ring that no cluster of 8 holds (a very
//   large scope). Bounded by the same barriers over all W diagonals,
//   several a thread.
//
// Within every build nothing per cell lives in a register across a
// barrier except the narrow build's cell of s + 1 (a thread owns one
// diagonal there; the cluster build's threads own three, so it writes
// them to the ring like the general build): the compute
// of s + 1 writes each component's cells into its ring row untrimmed (no
// source row shares that slot), and after the trim reduction the cells
// outside the trimmed band go back to NULL. The ring keeps a depth per
// component: M is read as far back as the scope (the largest penalty sum
// plus one), a gap component only at its own extension distance, so it
// keeps gap_extension + 1 rows. Gap-affine at 4/6/2 has 9 + 2 * 3 = 15
// rows (15.4 KB at W = 256); the 2-piece metric at 4/6/2/24/1 has
// 26 + 2 * 3 + 2 * 2 = 36 rows (73.7 KB at W = 512) where five components
// of 26 rows each would not fit one block. Extension reads the packed
// equality words bits[q, b, w] from word off >> 5 upward and stops at the
// first mismatch (__ffs of the inverted word), with reads coalesced across
// w; given the run-length table R[h, b, w] it is one load a cell instead,
// off += R[min(off, Ltp - 1), b, w], with the same bytes out (a run-time
// branch, uniform over the launch: no further instantiation). Given the
// token rows instead (batches whose words would not fit the card: a 50 kb
// batch's words take about 100 times its ring), a cell compares the
// pattern from v = off - k and the text from h = off in place, 4 bytes a
// step (two aligned 32-bit loads a row joined by a funnel shift,
// __vcmpeq4, the first mismatch by __ffs), or one int32 class mask a step
// under match classes, to the first mismatch (chunk_run): the reference's
// chunked extension (pywfa_tpu/ops/engine.py::_extend_band), the same
// bytes out, and no per-cell tensor at all; a run-time branch as well,
// taken by every build but the narrow one. A segment
// of a segmented run covers scores [seg_base, seg_base + S_cap - 1]: it
// loads the pair's carry, bands and ring from the state unless it is the
// first, records choice level s - seg_base, and stores the state at its
// end, the same bytes on every build, so consecutive segments may run on
// different builds; a pair still running then reports ST_OVERFLOW_S in
// the result and stays running in the state; a pair that is done returns
// at once.
//
// Four template parameters select the variant. kMetric picks the step:
// gap-affine computes M, I1, D1 from M at s+1-x and s+1-(o+e) and I1/D1 at
// s+1-e; the 2-piece metric adds I2, D2 with their own distances and the
// five-way priority X > D2 > D1 > I2 > I1, with extend bits 5-6 in the
// choice byte; gap-linear has M alone, mismatch from s+1-x and both gaps
// from s+1-indel; edit and indel have M alone and take every candidate
// from s (indel has no mismatch), and end a pair whose wavefront came out
// empty at the next step instead of counting null steps. kSpan is the
// span: end to end; ends-free with match == 0, which seeds WF0 with the
// begin-free diagonals [-pattern_begin_free, text_begin_free]; or
// ends-free with a match bonus, where WF0 is the single cell k = 0 and
// every score s with s % -match == 0 seeds the cells k = s / -match and
// k = -s / -match while the begin frees reach that far, as a wavefront of
// the seeds alone on a null step. Both ends-free spans end at the lowest
// diagonal whose cell reached an end-free boundary. kRecord = false is the
// score-only scope: no choice bytes, no choices pointer. kHeur compiles
// the heuristic cascade in, between the termination and the compute of
// s + 1: the strategy bits and parameters are kernel arguments, and since
// a block, a warp or a cluster is one pair every branch of the cascade is
// uniform over it, so its reductions sit behind branches that most steps
// skip. The cascade prunes the band of M at score s in registers, then
// installs it in the ring and cuts every gap component's row of score s to
// it; the bands of those rows are kept in registers, so the install reads
// no shared lo/hi pair that another thread writes.
//
// What bounds it on the H100: not bytes nor arithmetic (a short-read
// batch reads a few MB of words and computes a few million cells; a 10 kb
// batch of 16 pairs some hundred million cells), but the dependent latency
// of the score steps, and for the recording scope the bytes of the choice
// record's [S_cap, B, W] memset before every recording launch.

// A band that outgrows W, at WF0 or later, reports ST_OVERFLOW_W instead
// of being clamped silently, as the XLA engine of the reference package
// does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kNull = -(1 << 30);
constexpr int kNullThreshold = kNull / 2;
constexpr int kBig = 1 << 30;

// kMetric values (pywfa_tpu_torch/ops/fused_loop.py::METRIC_CODE)
constexpr int kAffine = 0;
constexpr int kAffine2p = 1;
constexpr int kLinear = 2;
constexpr int kEdit = 3;
constexpr int kIndel = 4;
constexpr int kMaxComps = 5;  // M, I1, D1, I2, D2

// kSpan values (pywfa_tpu_torch/ops/fused_loop.py::SPANS)
constexpr int kEndToEnd = 0;
constexpr int kEndsFreeWf0 = 1;  // match == 0: the begin frees seed WF0
constexpr int kSeeded = 2;       // match != 0: seeds at every -match score

// HeuristicStrategy bits
constexpr int kBandedStatic = 1;
constexpr int kBandedAdaptive = 2;
constexpr int kWfAdaptive = 4;
constexpr int kXdrop = 8;
constexpr int kZdrop = 16;
constexpr int kWfMash = 32;
constexpr int kHeurReductions = 7;  // partial rows of the cascade

__host__ __device__ constexpr int n_comps(int metric) {
  return metric == kAffine ? 3 : (metric == kAffine2p ? 5 : 1);
}

constexpr int ST_END_REACHED = 1;
constexpr int ST_END_UNREACHABLE = 2;
constexpr int ST_MAX_STEPS = 3;
constexpr int ST_OVERFLOW_W = 4;
constexpr int ST_OVERFLOW_S = 5;

constexpr int MSRC_NONE = 0;
constexpr int MSRC_X = 1;
constexpr int MSRC_I1 = 2;
constexpr int MSRC_D1 = 3;
constexpr int MSRC_I2 = 4;
constexpr int MSRC_D2 = 5;
constexpr int MSRC_SEED = 7;

constexpr int M = 0;
constexpr int I1 = 1;
constexpr int D1 = 2;
constexpr int I2 = 3;
constexpr int D2 = 4;

// the in-place compare's modes
// (pywfa_tpu_torch/ops/fused_loop.py::CHUNK_MODES): int8 tokens byte for
// byte, with a wildcard, int32 class masks
constexpr int kChunkBytes = 0;
constexpr int kChunkWildcard = 1;
constexpr int kChunkClasses = 2;
// the rows' sentinels (PATTERN_PAD = 1, TEXT_PAD = 2) in every byte lane
constexpr uint32_t kPatternPad4 = 0x01010101u;
constexpr uint32_t kTextPad4 = 0x02020202u;

// the build codes of wfa_fused_loop (pywfa_tpu_torch/ops/fused_loop.py::BUILDS)
constexpr int kBuildGeneral = 0;
constexpr int kBuildNarrow = 1;
constexpr int kBuildGroup = 2;
constexpr int kBuildCluster = 3;
constexpr int kClusterMax = 8;  // the portable cluster size
// threads of one CTA of the cluster build: a slice of at most 1024
// diagonals, three a thread, in whole warps
constexpr int kClusterThreads = 384;

// ints of one pair's carry in the state of a segmented run: s, status,
// final_s, end_k, end_off, the null-step count, the cascade's wait and
// historic maximum (score, diagonal, offset, valid), done
// (pywfa_tpu_torch/ops/fused_loop.py::CARRY)
constexpr int kCarry = 12;

struct Params {
  const uint32_t* bits;  // [NQ, B, W] packed equality words, or nullptr
  // the run-length table R[h, b, w] (csrc/lcp_table.cu), uint8 or int16,
  // read instead of the words when not nullptr; Ltp is its h extent
  const void* table;
  int table_u8, Ltp;
  // the token rows [B, Lpp] and [B, Ltr], compared in place when `pat` is
  // not nullptr: int8 tokens, or int32 class masks (chunk_mode); the
  // wildcard byte in every byte lane (kChunkWildcard)
  const void* pat;
  const void* txt;
  int Lpp, Ltr, chunk_mode;
  uint32_t wildcard4;
  const int32_t* plen;   // [B]
  const int32_t* tlen;   // [B]
  const int32_t* frees;  // [B, 4]: pattern begin/end, text begin/end free
  uint8_t* choices;      // [S_cap, B, W], zero on entry; unused unless kRecord
  int32_t* res;          // [4, B]: status, final_s, end_k, end_off;
                         // then the group build's pair counter
  // a segmented run's state, read unless `fresh` and written at the end:
  // the ring [B, rows, W], its bands [B, rows, 2] and the carry
  // [B, kCarry]; all nullptr for a one-shot run. `ring` alone is also the
  // ring's storage when it does not fit shared memory (ring_global).
  int32_t* ring;
  int32_t* lohi;
  int32_t* carry;
  int fresh, ring_global;
  // the segment covers scores [seg_base, seg_base + S_cap - 1]; the choice
  // level of score s is s - seg_base
  int seg_base;
  // threads of a block, and units a pair: the group build's G warps,
  // the cluster build's CTAs (each owning W / cluster diagonals), 1 on
  // the general build, whose threads own diagonals tid, tid + T, ...
  int threads, cluster;
  int B, W, NQ, S_cap, scope, max_steps;
  // the heuristic cascade (read when kHeur): HeuristicStrategy bits and
  // their parameters; swg_match is the match weight of the drop
  // heuristics' Smith-Waterman score
  int strategy, min_wf_len, max_dist, steps_between, xdrop, zdrop;
  int band_min_k, band_max_k, swg_match;
  // ends-free match seeding: -match (read when kSpan == kSeeded)
  int seed_div;
  // score distances from s + 1 back to the source wavefronts: M for a
  // mismatch; M opening and I1/D1 extending gap piece 1 (gap-linear: its
  // indel penalty, nothing extends); the same for piece 2
  int x, o1, e1, o2, e2;
  // the ring: component c owns rows [base[c], base[c] + depth[c])
  int base[kMaxComps], depth[kMaxComps], rows;
};

// One wavefront of the ring: its row in shared memory (nullptr for a
// negative score, which reads as all-NULL) and its band.
struct Wf {
  const int* row;
  int lo, hi;
  bool null_;
};

// The wavefront of component `comp` at score s1 - dist, where `slot1` is
// the component's ring slot of score s1 (s1 % depth, kept incrementally:
// the loop takes no modulo) and 0 < dist < depth.
// `RS` is the ring's row stride: W, or a slice's width on the cluster build.
__device__ __forceinline__ Wf read_wf(const int* off, const int* lohi,
                                      const Params& p, int comp, int slot1,
                                      int dist, int s1, int RS) {
  Wf f;
  if (s1 - dist < 0) {
    f.row = nullptr;
    f.lo = 1;
    f.hi = -1;
  } else {
    int j = slot1 - dist;
    if (j < 0) j += p.depth[comp];
    const int i = p.base[comp] + j;
    f.row = off + i * RS;
    f.lo = lohi[2 * i];
    f.hi = lohi[2 * i + 1];
  }
  f.null_ = f.lo > f.hi;
  return f;
}

// f.row[i], NULL outside [0, W) (the reference's NULL-padded shift)
__device__ __forceinline__ int at(const Wf& f, int i, int W) {
  return (f.row == nullptr || i < 0 || i >= W) ? kNull : f.row[i];
}

__device__ __forceinline__ int pack(int value, int prio) {
  return value >= 0 ? ((value << 3) | prio) : kNull;
}

__device__ __forceinline__ int lim_lo(const Wf& f, int widen) {
  return f.null_ ? kBig : f.lo - widen;
}

__device__ __forceinline__ int lim_hi(const Wf& f, int widen) {
  return f.null_ ? -kBig : f.hi + widen;
}

// One gap component's cell: open from M (prio 0) vs extend (prio 1, wins
// ties); `add` is 1 for an insertion, which advances the offset. An
// all-invalid cell keeps the raw value, which only M's bounds check nulls.
__device__ __forceinline__ int gap_cell(int open_src, int ext_src, int add,
                                        int* ext) {
  const int gp = max(pack(open_src + add, 0), pack(ext_src + add, 1));
  *ext = (gp >= 0 && (gp & 7) == 1) ? 1 : 0;
  return gp < 0 ? max(open_src, ext_src) + add : (gp >> 3);
}

// M source of a one-component metric from the packed maximum's priority
__device__ __forceinline__ int one_comp_source(int pm) {
  const int pr = pm & 7;
  return pr == 5 ? MSRC_X : (pr == 3 ? MSRC_D1 : (pr == 1 ? MSRC_I1
                                                          : MSRC_NONE));
}

constexpr unsigned kFull = 0xFFFFFFFFu;

// The 4 bytes of a row at [i, i + 4), little-endian, of which the first
// `rem` (> 0) lie inside the row: the aligned word that holds byte i and,
// where the 4 bytes reach into the next aligned word and a byte of the row
// lies there, that word too, joined by a funnel shift. No word is read
// that holds no byte of the row; the bytes past the row read as anything.
__device__ __forceinline__ uint32_t row_bytes4(const uint8_t* row, int i,
                                               int rem) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + i);
  const uint32_t* w =
      reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
  const int mis = static_cast<int>(a & 3);
  const uint32_t lo = __ldg(w);
  const uint32_t hi = (mis != 0 && rem > 4 - mis) ? __ldg(w + 1) : 0u;
  return __funnelshift_r(lo, hi, 8 * mis);
}

// The run of pair b's cell from pattern position v and text position h:
// how many positions match in a row, the pattern from v against the text
// from h, as the packed words would count them. A cell whose v or h lies
// outside the pair's lengths runs 0 and reads nothing (the reference's
// `ok` mask: a cell above the offset, v < 0, never reads pat[b, v]). A
// run stops at the first mismatch, which the sentinels past each length
// guarantee before the row's end, and at the row's end itself (a
// position past it mismatches), so no load leaves the row. Bytes: equal
// bytes match; with the wildcard, that byte matches any byte on either
// side but a sentinel, and a sentinel matches nothing; class masks match
// when they intersect (the sentinels' masks are 0). A long exact run is
// one thread's loop for as long as it runs: never cut at a chunk.
__device__ int chunk_run(const Params& p, int b, int v, int h, int plen,
                         int tlen) {
  if (v < 0 || h < 0 || v >= plen || h >= tlen) return 0;
  const int lim = min(p.Lpp - v, p.Ltr - h);
  if (p.chunk_mode == kChunkClasses) {
    const int32_t* pr = static_cast<const int32_t*>(p.pat) +
                        static_cast<size_t>(b) * p.Lpp + v;
    const int32_t* tr = static_cast<const int32_t*>(p.txt) +
                        static_cast<size_t>(b) * p.Ltr + h;
    int i = 0;
    while (i < lim && (__ldg(pr + i) & __ldg(tr + i)) != 0) ++i;
    return i;
  }
  const uint8_t* pr = static_cast<const uint8_t*>(p.pat) +
                      static_cast<size_t>(b) * p.Lpp + v;
  const uint8_t* tr = static_cast<const uint8_t*>(p.txt) +
                      static_cast<size_t>(b) * p.Ltr + h;
  const bool wild = p.chunk_mode == kChunkWildcard;
  for (int i = 0;; i += 4) {
    const int rem = lim - i;
    const uint32_t a = row_bytes4(pr, i, rem);
    const uint32_t t = row_bytes4(tr, i, rem);
    uint32_t eq = __vcmpeq4(a, t);
    if (wild) {
      eq = (eq | __vcmpeq4(a, p.wildcard4) | __vcmpeq4(t, p.wildcard4)) &
           ~__vcmpeq4(a, kPatternPad4) & ~__vcmpeq4(t, kTextPad4);
    }
    // the positions past the row mismatch
    if (rem < 4) eq &= (1u << (8 * rem)) - 1u;
    if (eq != 0xFFFFFFFFu) return i + ((__ffs(~eq) - 1) >> 3);
    if (rem == 4) return lim;
  }
}

// The block reductions of loop_body, and on the cluster build the
// cluster's. Every thread posts its value, already folded over the
// diagonals it owns, into a reduction's row: a warp reduction, then the
// warp's partial at its place in the row (a block has at most 32 warps).
// On the cluster build the row has C * nwarps places, and lanes 0..C-1 of
// each warp write the partial into the row of every CTA of the cluster
// through distributed shared memory, so that one cluster barrier takes the
// place of the block's and no CTA-level fold is needed before it. The
// caller places the barrier (sync), and every warp folds its own CTA's
// row: each lane a stride of it, and one more warp reduction gives every
// thread the result. The callers' branches are uniform over the block (the
// cluster), so every lane is there. A row is posted again only after
// another barrier: every fold of its last use is then done.
template <bool kCluster>
struct Reducer {
  int lane, warp, n;  // n: the places of a row
  int C, rank, nwarps;

  __device__ __forceinline__ void put(int* row, int v) const {
    if constexpr (kCluster) {
      if (lane < C) {
        int* dst = cooperative_groups::this_cluster().map_shared_rank(
            row, static_cast<unsigned>(lane));
        dst[rank * nwarps + warp] = v;
      }
    } else {
      if (lane == 0) row[warp] = v;
    }
  }
  __device__ __forceinline__ void post_min(int* row, int v) const {
    put(row, __reduce_min_sync(kFull, v));
  }
  __device__ __forceinline__ void post_max(int* row, int v) const {
    put(row, __reduce_max_sync(kFull, v));
  }
  __device__ __forceinline__ int fold_min(const int* row) const {
    int v = lane < n ? row[lane] : kBig;
    if constexpr (kCluster) {
      for (int j = lane + 32; j < n; j += 32) v = min(v, row[j]);
    }
    return __reduce_min_sync(kFull, v);
  }
  __device__ __forceinline__ int fold_max(const int* row) const {
    int v = lane < n ? row[lane] : -kBig;
    if constexpr (kCluster) {
      for (int j = lane + 32; j < n; j += 32) v = max(v, row[j]);
    }
    return __reduce_max_sync(kFull, v);
  }
  __device__ __forceinline__ void sync() const {
    if constexpr (kCluster) {
      cooperative_groups::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
};

// wfmash's length-normalised distance, float32 in a fixed order: divide,
// multiply, truncate (saturating, NaN to 0); nothing contracts
__device__ __forceinline__ int mash_dist(int left, int len, float mfactor) {
  return __float2int_rz(__fmul_rn(
      __fdiv_rn(__int2float_rn(left), __int2float_rn(len)), mfactor));
}

// The loop of one pair, in the build kBuild. The narrow build is the
// one-shot run of a band of at most 1024 diagonals on the equality words:
// one diagonal a thread, the ring in shared memory, no state and no table,
// so every branch on those folds away and each strided pass below is a
// single step (see launch()). The cluster build runs one pair on a cluster
// of C CTAs: CTA r owns the diagonals [r * W / C, (r + 1) * W / C), a
// thread owning every T-th of them, and the ring's columns of them
// ([rows][W / C] in its shared memory); a cell
// of another CTA's slice (a neighbour at a slice edge, the end cell, the
// cascade's sampled cells) is read through distributed shared memory after
// a cluster barrier, and every reduction is the cluster's (Reducer). Every
// value that steers the loop (s, the bands, done, status) is uniform over
// the cluster.
template <int kMetric, int kSpan, bool kRecord, bool kHeur, int kBuild>
__device__ __forceinline__ void loop_body(const Params& p) {
  constexpr int kComps = n_comps(kMetric);
  constexpr bool kEditLike = kMetric == kEdit || kMetric == kIndel;
  constexpr bool kEndsFree = kSpan != kEndToEnd;
  constexpr bool kSeeding = kSpan == kSeeded;
  constexpr bool kNarrow = kBuild == kBuildNarrow;
  constexpr bool kCluster = kBuild == kBuildCluster;
  extern __shared__ int smem[];
  const int W = p.W;
  const int T = blockDim.x;
  const int scope = p.scope;
  const int C = kCluster ? p.cluster : 1;
  const int rank = kCluster ? static_cast<int>(blockIdx.x) % C : 0;
  const int b = kCluster ? static_cast<int>(blockIdx.x) / C : blockIdx.x;
  // the ring's row stride (a slice's width on the cluster build) and the
  // diagonals [wbase, wend) this block owns
  const int RS = kCluster ? W / C : W;
  const int wbase = kCluster ? rank * RS : 0;
  const int wend = kCluster ? wbase + RS : W;
  const int tid = threadIdx.x;
  if (kNarrow) __builtin_assume(tid < W);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
  // the places of a reduction's row (Reducer)
  const int RR = kCluster ? C * nwarps : 32;
  const Reducer<kCluster> red_ops{lane, warp, kCluster ? RR : nwarps, C, rank,
                                  nwarps};
  int* lohi = smem;                       // [rows][2]
  int* red = lohi + p.rows * 2;           // [2 * kComps][RR] trim partials
  int* term = red + 2 * kComps * RR;      // [RR] ends-free hit partials
  int* hred = term + RR;  // [kHeurReductions][RR] cascade partials (kHeur)
  // the ring [rows][RS]: shared memory, or this pair's slice of the global
  // ring when the rows do not fit one block's shared memory
  const bool fresh = kNarrow || p.fresh;
  const bool ring_global = !kNarrow && !kCluster && p.ring_global;
  const int seg_base = kNarrow ? 0 : p.seg_base;
  int* ring_g = (kNarrow || p.ring == nullptr)
                    ? nullptr
                    : p.ring + static_cast<size_t>(b) * p.rows * W;
  int* off = ring_global ? ring_g
                         : hred + (kHeur ? kHeurReductions * RR : 0);
  // the CTAs of the neighbouring slices (cluster build)
  const int* left = nullptr;
  const int* right = nullptr;
  if constexpr (kCluster) {
    auto cluster = cooperative_groups::this_cluster();
    if (rank > 0) left = cluster.map_shared_rank(off, rank - 1);
    if (rank < C - 1) right = cluster.map_shared_rank(off, rank + 1);
  }
  // this thread's first diagonal
  const int w0 = wbase + tid;

  const int kmin = -(W / 2);
  const int plen = p.plen[b];
  const int tlen = p.tlen[b];
  const size_t BW = static_cast<size_t>(p.B) * W;
  const size_t bW = static_cast<size_t>(b) * W;
  const uint32_t* bits = p.bits == nullptr ? nullptr : p.bits + bW;
  const uint8_t* table8 =
      (kNarrow || p.table == nullptr)
          ? nullptr
          : static_cast<const uint8_t*>(p.table) + (p.table_u8 ? bW : 2 * bW);
  // the token rows compared in place (never on the narrow build)
  const bool in_place = !kNarrow && p.pat != nullptr;
  uint8_t* choices = kRecord ? p.choices + bW : nullptr;
  const int NQ32 = p.NQ * 32;
  const int seg_end = seg_base + p.S_cap - 1;
  int32_t* carry = (kNarrow || p.carry == nullptr)
                       ? nullptr
                       : p.carry + static_cast<size_t>(b) * kCarry;

  // the cell of ring row `row` at diagonal w, whichever block owns it
  auto cell = [&](int row, int w) -> int {
    if constexpr (kCluster) {
      const int r = w / RS;
      const int* base =
          r == rank ? off
                    : cooperative_groups::this_cluster().map_shared_rank(
                          off, static_cast<unsigned>(r));
      return base[row * RS + w - r * RS];
    } else {
      return off[row * W + w];
    }
  };
  // f.row[i], NULL outside [0, W) (the reference's NULL-padded shift); on
  // the cluster build i is w - 1, w or w + 1 of this thread's w, and a
  // neighbour past the slice's edge is read from the next CTA's ring
  auto at_ = [&](const Wf& f, int i) -> int {
    if constexpr (kCluster) {
      if (f.row == nullptr || i < 0 || i >= W) return kNull;
      const int j = i - wbase;
      if (j < 0) return left[(f.row - off) + RS - 1];
      if (j >= RS) return right[f.row - off];
      return f.row[j];
    } else {
      return at(f, i, W);
    }
  };

  int pbf = 0, pef = 0, tbf = 0, tef = 0;
  if (kEndsFree) {
    const int32_t* fr = p.frees + 4 * static_cast<size_t>(b);
    pbf = fr[0];
    pef = fr[1];
    tbf = fr[2];
    tef = fr[3];
  }

  // block-uniform state: every thread computes the same values. The
  // cascade's carry: steps to the next cutoff, and the historic maximum of
  // the drop heuristics (its score, diagonal, offset)
  int s = 0, status = 0, final_s = 0, end_k = 0, end_off = kNull;
  int nnull = 0;
  int h_wait = p.steps_between;
  int hm_sw = 0, hm_k = 0, hm_off = kNull;
  bool hm_valid = false;
  bool done = false;
  if (fresh) {
    // WF0: M at score 0 holds the begin-free seeds, diagonals
    // [-pattern_begin_free, text_begin_free] at offset max(k, 0); without
    // the ends-free span only k = 0, offset 0; with a match bonus
    // (kSeeding) WF0 is k = 0 alone and the begin frees seed later scores
    int wf0_lo = 0, wf0_hi = 0;
    if (kSpan == kEndsFreeWf0) {
      wf0_lo = -pbf;
      wf0_hi = tbf;
    }
    for (int i = tid; i < p.rows * RS; i += T) {
      const int k = kmin + wbase + i;
      off[i] = (i < RS && k >= wf0_lo && k <= wf0_hi) ? max(k, 0) : kNull;
    }
    for (int i = tid; i < p.rows; i += T) {
      lohi[2 * i] = (i == 0) ? wf0_lo : 1;
      lohi[2 * i + 1] = (i == 0) ? wf0_hi : -1;
    }
    // seeds past the band: the pair escalates before its first step
    done = kSpan == kEndsFreeWf0 &&
           (wf0_lo < kmin + 2 || wf0_hi > kmin + W - 3);
    if (done) status = ST_OVERFLOW_W;
  } else {
    // a later segment: the carry, the bands and the ring come from the
    // state the segment before stored
    s = carry[0];
    status = carry[1];
    final_s = carry[2];
    end_k = carry[3];
    end_off = carry[4];
    nnull = carry[5];
    h_wait = carry[6];
    hm_sw = carry[7];
    hm_k = carry[8];
    hm_off = carry[9];
    hm_valid = carry[10] != 0;
    if (carry[11] != 0) {
      // a pair that is done: its result again, its state untouched
      if (tid == 0 && rank == 0) {
        p.res[b] = status;
        p.res[p.B + b] = final_s;
        p.res[2 * p.B + b] = end_k;
        p.res[3 * p.B + b] = end_off;
      }
      return;
    }
    if (!ring_global) {
      // this block's columns of the ring
      for (int row = 0; row < p.rows; ++row) {
        for (int j = tid; j < RS; j += T) {
          off[row * RS + j] = ring_g[static_cast<size_t>(row) * W + wbase + j];
        }
      }
    }
    const int32_t* lg = p.lohi + static_cast<size_t>(b) * p.rows * 2;
    for (int i = tid; i < p.rows * 2; i += T) lohi[i] = lg[i];
  }
  // the end cell k = tlen - plen; on the cluster build, end to end, the
  // thread that owns it tells every CTA in term[0] whether it reached the
  // end (none does when it lies outside the band)
  const int ak = tlen - plen;
  const int aw = ak - kmin;
  if (kCluster && !kEndsFree && tid == 0) term[0] = 0;
  // (the cluster build: every CTA of the cluster has started before any
  // reads another's shared memory)
  red_ops.sync();

  // each component's ring slot of score s (s % depth; the loop keeps it
  // without the modulo) and the band of its row of score s: M's, and the
  // gap components' that the cascade cuts
  int slot[kComps], g_lo[kComps], g_hi[kComps];
#pragma unroll
  for (int c = 0; c < kComps; ++c) {
    slot[c] = s % p.depth[c];
    const int row = p.base[c] + slot[c];
    g_lo[c] = lohi[2 * row];
    g_hi[c] = lohi[2 * row + 1];
  }
  int m_lo = g_lo[M], m_hi = g_hi[M];

  while (!done && s < seg_end) {
    int* m_row = off + slot[M] * RS;  // M owns rows [0, scope)
    const bool m_null = m_lo > m_hi;
    // feasibility probe: a run of null steps longer than the scope
    if (m_null && nnull > scope) {
      status = ST_END_UNREACHABLE;
      final_s = s;
      done = true;
      break;
    }

    // --- extension: first mismatch at or after the cell's offset, by the
    // packed equality words, by the run-length table or by the token rows
    // compared in place ---
    int first_hit = W;
    if (!m_null) {
      for (int w = w0; w < wend; w = kNarrow ? wend : w + T) {
        const int k = kmin + w;
        int m_off = m_row[w - wbase];
        const bool inband = k >= m_lo && k <= m_hi;
        if (inband && m_off >= 0 && m_off <= tlen) {
          if (table8 != nullptr) {
            const size_t at_h =
                static_cast<size_t>(min(m_off, p.Ltp - 1)) * BW + w;
            m_off += p.table_u8
                         ? static_cast<int>(table8[at_h])
                         : static_cast<int>(reinterpret_cast<const int16_t*>(
                               table8)[at_h]);
          } else if (in_place) {
            m_off += chunk_run(p, b, m_off - k, m_off, plen, tlen);
          } else {
            const int idx = min(m_off, NQ32 - 1);
            int q = idx >> 5;
            uint32_t mq =
                ~__ldg(bits + q * BW + w) & (0xFFFFFFFFu << (idx & 31));
            while (mq == 0 && ++q < p.NQ) mq = ~__ldg(bits + q * BW + w);
            // the sentinel padding guarantees a mismatch before the row end
            const int fm = (mq != 0)
                               ? q * 32 + __ffs(static_cast<int>(mq)) - 1
                               : NQ32;
            m_off += fm - idx;
          }
          m_row[w - wbase] = m_off;
        }
        if (kEndsFree) {
          // a cell on an end-free boundary: the text consumed with at most
          // pattern_end_free bases left, or the pattern with at most
          // text_end_free left; the lowest such diagonal wins
          const int v = m_off - k;
          if (inband && m_off > kNullThreshold &&
              ((m_off >= tlen && plen - v <= pef) ||
               (v >= plen && tlen - m_off <= tef))) {
            first_hit = min(first_hit, w);
          }
        }
      }
    }
    if (kEndsFree) red_ops.post_min(term, first_hit);
    if constexpr (kCluster && !kEndsFree) {
      if (aw >= w0 && aw < wend && (aw - w0) % T == 0) {
        const int reached = !m_null && m_lo <= ak && ak <= m_hi &&
                            m_row[aw - wbase] >= tlen;
        for (int r = 0; r < C; ++r) {
          cooperative_groups::this_cluster().map_shared_rank(
              term, static_cast<unsigned>(r))[0] = reached;
        }
      }
    }
    red_ops.sync();

    // --- termination ---
    if (kEndsFree) {
      const int first = red_ops.fold_min(term);
      if (first < W) {
        status = ST_END_REACHED;
        final_s = s;
        end_k = first + kmin;
        end_off = cell(slot[M], first);
        done = true;
        break;
      }
    } else {
      // the end cell reached offset tlen
      const bool reached =
          kCluster ? term[0] != 0
                   : !m_null && m_lo <= ak && ak <= m_hi && aw >= 0 &&
                         aw < W && cell(slot[M], aw) >= tlen;
      if (reached) {
        status = ST_END_REACHED;
        final_s = s;
        end_k = ak;
        end_off = tlen;
        done = true;
        break;
      }
    }

    // --- heuristic cascade: prune the band of M[s] before the compute
    // reads it. Every condition below is uniform over the block; every
    // per-cell value is computed again from the ring in each pass. ---
    if constexpr (kHeur) {
      if (!m_null) {
        --h_wait;
        int cur_lo = m_lo, cur_hi = m_hi;
        const int st = p.strategy;
        if ((st & (kWfAdaptive | kWfMash)) && h_wait <= 0 &&
            cur_hi - cur_lo + 1 >= p.min_wf_len) {
          // wf-adaptive / wfmash: keep the diagonals within max_dist of
          // the least distance to the end, cutting from below up to the
          // end diagonal and from above down to it
          const float mfactor = __fdiv_rn(__int2float_rn(plen + tlen), 2.0f);
          auto dist_of = [&](int k, int m_off) {
            if (m_off < 0) return -kNull;
            const int v = m_off - k;
            if (st & kWfMash) {
              return max(mash_dist(plen - v, plen, mfactor),
                         mash_dist(tlen - m_off, tlen, mfactor));
            }
            return max(plen - v, tlen - m_off);
          };
          int mn = kBig;
          for (int w = w0; w < wend; w = kNarrow ? wend : w + T) {
            const int k = kmin + w;
            const bool hband = k >= cur_lo && k <= cur_hi;
            mn = min(mn, hband ? dist_of(k, m_row[w - wbase])
                               : max(plen, tlen));
          }
          red_ops.post_min(hred, mn);
          red_ops.sync();
          const int mind = red_ops.fold_min(hred);
          const int top_limit = min(ak, cur_hi);
          // the highest kept diagonal above ak is the highest above
          // max(ak, new lo) too, if any is
          int f = W, l = -1;
          for (int w = w0; w < wend; w = kNarrow ? wend : w + T) {
            const int k = kmin + w;
            const bool keep = k >= cur_lo && k <= cur_hi &&
                              dist_of(k, m_row[w - wbase]) - mind <= p.max_dist;
            if (keep && k < top_limit) f = min(f, w);
            if (keep && k > ak) l = max(l, w);
          }
          red_ops.post_min(hred + RR, f);
          red_ops.post_max(hred + 2 * RR, l);
          red_ops.sync();
          const int first = red_ops.fold_min(hred + RR);
          const int last = red_ops.fold_max(hred + 2 * RR);
          const int lo_red = first < W ? first + kmin : max(top_limit, cur_lo);
          const int new_lo = max(lo_red, cur_lo);
          const int bot_limit = max(ak, new_lo);
          const int hi_red = (last >= 0 && last + kmin > bot_limit)
                                 ? last + kmin
                                 : min(bot_limit, cur_hi);
          cur_hi = min(hi_red, cur_hi);
          cur_lo = new_lo;
          h_wait = p.steps_between;
        }
        if ((st & (kXdrop | kZdrop)) && h_wait <= 0) {
          // the Smith-Waterman score of each cell, its maximum and the
          // first diagonal that attains it; x-drop wins over z-drop
          // (C division truncates, as the reference's does)
          auto sw_of = [&](int k, int m_off) {
            return (k >= cur_lo && k <= cur_hi && m_off >= 0)
                       ? (p.swg_match * (m_off - k + m_off) - s) / 2
                       : -kBig;
          };
          int mx = -kBig;
          for (int w = w0; w < wend; w = kNarrow ? wend : w + T) {
            mx = max(mx, sw_of(kmin + w, m_row[w - wbase]));
          }
          red_ops.post_max(hred + 3 * RR, mx);
          red_ops.sync();
          const int cmax = red_ops.fold_max(hred + 3 * RR);
          const bool xd = (st & kXdrop) != 0;
          int ci = W, fx = W, lx = -1;
          for (int w = w0; w < wend; w = kNarrow ? wend : w + T) {
            const int sw = sw_of(kmin + w, m_row[w - wbase]);
            if (sw == cmax) ci = min(ci, w);
            if (xd && sw > -kBig && hm_sw - sw < p.xdrop) {
              fx = min(fx, w);
              lx = max(lx, w);
            }
          }
          red_ops.post_min(hred + 4 * RR, ci);
          if (xd) {
            red_ops.post_min(hred + 5 * RR, fx);
            red_ops.post_max(hred + 6 * RR, lx);
          }
          red_ops.sync();
          const int cidx = red_ops.fold_min(hred + 4 * RR);
          const bool improved = !hm_valid || cmax > hm_sw;
          if (xd) {
            if (hm_valid) {
              const int firstx = red_ops.fold_min(hred + 5 * RR);
              const int lastx = red_ops.fold_max(hred + 6 * RR);
              // in sequence: the new hi reads the new lo
              cur_lo = firstx < W ? firstx + kmin : cur_hi + 1;
              cur_hi = firstx < W ? lastx + kmin : cur_lo - 1;
            }
            if (improved) {
              hm_sw = cmax;
              hm_k = cidx + kmin;
            }
          } else {
            const bool zdropped =
                hm_valid && !improved && hm_sw - cmax > p.zdrop;
            if (improved) {
              hm_sw = cmax;
              hm_k = cidx + kmin;
              hm_off = cell(slot[M], min(cidx, W - 1));
            }
            if (zdropped) {
              // the pair ends at the historic maximum's cell
              status = ST_END_UNREACHABLE;
              final_s = s;
              end_k = hm_k;
              end_off = hm_off;
              done = true;
              break;
            }
          }
          hm_valid = true;
          h_wait = p.steps_between;
        }
        if (st & kBandedStatic) {
          // no wait gate
          cur_lo = max(cur_lo, p.band_min_k);
          cur_hi = min(cur_hi, p.band_max_k);
        } else if (st & kBandedAdaptive) {
          const int wf_len = cur_hi - cur_lo + 1;
          const int max_len = p.band_max_k - p.band_min_k + 1;
          // the wait resets whenever the wavefront has 4 diagonals, even
          // with nothing to cut
          if (h_wait <= 0 && wf_len >= 4) {
            if (wf_len > max_len) {
              // move the window of max_len diagonals toward the end whose
              // sampled cells are nearer the alignment's end
              auto dist_at = [&](int kq) {
                const int o = cell(slot[M], min(max(kq - kmin, 0), W - 1));
                return o >= 0 ? max(plen - (o - kq), tlen - o) : -kNull;
              };
              const int leeway = (wf_len - max_len) / 2;
              const int quarter = wf_len / 4;
              const int d0 = dist_at(cur_lo);
              const int d1 = dist_at(cur_lo + quarter);
              const int d2 = dist_at(cur_lo + 2 * quarter);
              const int d3 = dist_at(cur_hi);
              const int new_lo0 = cur_lo + (d0 > d3 ? leeway : 0) +
                                  (d1 > d2 ? leeway : 0);
              cur_hi = min(new_lo0 + max_len - 1, cur_hi);
              cur_lo = max(new_lo0, cur_lo);
            }
            h_wait = p.steps_between;
          }
        }
        if (cur_lo != m_lo || cur_hi != m_hi) {
          // install M's pruned band, cut every gap component's row of
          // score s to it (a null row stays null), and let the compute
          // of s + 1 see both; the barrier first: the banded-adaptive
          // cut above read cells of M's row that the install nulls
          red_ops.sync();
#pragma unroll
          for (int c = 1; c < kComps; ++c) {
            g_lo[c] = max(g_lo[c], cur_lo);
            g_hi[c] = min(g_hi[c], cur_hi);
          }
          for (int w = w0; w < wend; w = kNarrow ? wend : w + T) {
            const int k = kmin + w;
            if (k < cur_lo || k > cur_hi) m_row[w - wbase] = kNull;
#pragma unroll
            for (int c = 1; c < kComps; ++c) {
              if (k < g_lo[c] || k > g_hi[c]) {
                off[(p.base[c] + slot[c]) * RS + w - wbase] = kNull;
              }
            }
          }
          if (tid == 0) {
            lohi[2 * slot[M]] = cur_lo;
            lohi[2 * slot[M] + 1] = cur_hi;
#pragma unroll
            for (int c = 1; c < kComps; ++c) {
              const int row = p.base[c] + slot[c];
              lohi[2 * row] = g_lo[c];
              lohi[2 * row + 1] = g_hi[c];
            }
          }
          red_ops.sync();
        }
      }
    }

    // --- compute s + 1: what is uniform over the block first (the source
    // wavefronts, the new band, the seeds), then the cells ---
    const int s1 = s + 1;
    int slot1[kComps];  // the slots of score s + 1
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      slot1[c] = slot[c] + 1 == p.depth[c] ? 0 : slot[c] + 1;
    }
    // the source wavefronts: M for the mismatch (edit and indel: the one
    // wavefront of s), M opening and I/D extending each gap piece
    Wf mm, op, i1, d1, op2, i2, d2;
    // whether the component is produced at all (M on every non-null step,
    // a gap component only when one of its sources exists)
    bool prod[kComps];
    int lo_n, hi_n;
    bool all_null;
    if constexpr (kEditLike) {
      mm = read_wf(off, lohi, p, M, slot1[M], 1, s1, RS);
      lo_n = mm.lo - 1;
      hi_n = mm.hi + 1;
      all_null = mm.null_;
    } else if constexpr (kMetric == kLinear) {
      mm = read_wf(off, lohi, p, M, slot1[M], p.x, s1, RS);
      op = read_wf(off, lohi, p, M, slot1[M], p.o1, s1, RS);
      lo_n = min(lim_lo(mm, 0), lim_lo(op, 1));
      hi_n = max(lim_hi(mm, 0), lim_hi(op, 1));
      all_null = mm.null_ && op.null_;
    } else {
      mm = read_wf(off, lohi, p, M, slot1[M], p.x, s1, RS);
      op = read_wf(off, lohi, p, M, slot1[M], p.o1, s1, RS);
      i1 = read_wf(off, lohi, p, I1, slot1[I1], p.e1, s1, RS);
      d1 = read_wf(off, lohi, p, D1, slot1[D1], p.e1, s1, RS);
      lo_n = min(min(lim_lo(mm, 0), lim_lo(op, 1)),
                 min(lim_lo(i1, 1), lim_lo(d1, 1)));
      hi_n = max(max(lim_hi(mm, 0), lim_hi(op, 1)),
                 max(lim_hi(i1, 1), lim_hi(d1, 1)));
      all_null = mm.null_ && op.null_ && i1.null_ && d1.null_;
      prod[I1] = !(op.null_ && i1.null_);
      prod[D1] = !(op.null_ && d1.null_);
      if constexpr (kMetric == kAffine2p) {
        // I2 and D2 are the last two of the five components
        op2 = read_wf(off, lohi, p, M, slot1[M], p.o2, s1, RS);
        i2 = read_wf(off, lohi, p, I2, slot1[kComps - 2], p.e2, s1, RS);
        d2 = read_wf(off, lohi, p, D2, slot1[kComps - 1], p.e2, s1, RS);
        lo_n = min(lo_n, min(lim_lo(op2, 1),
                             min(lim_lo(i2, 1), lim_lo(d2, 1))));
        hi_n = max(hi_n, max(lim_hi(op2, 1),
                             max(lim_hi(i2, 1), lim_hi(d2, 1))));
        all_null = all_null && op2.null_ && i2.null_ && d2.null_;
        prod[kComps - 2] = !(op2.null_ && i2.null_);
        prod[kComps - 1] = !(op2.null_ && d2.null_);
      }
    }
    // edit and indel count no null steps (see the trim below)
    if (!kEditLike) nnull = all_null ? nnull + 1 : 0;
    // ends-free with a match bonus: seed the boundary at the scores
    // divisible by -match while the pair has any begin-free slack; on a
    // null step the wavefront is the seeds alone (and is not trimmed)
    bool null_step = all_null, seeded_null = false;
    bool seed_t = false, seed_p = false;
    int ek = 0;
    if constexpr (kSeeding) {
      if (s1 % p.seed_div == 0 && (pbf > 0 || tbf > 0)) {
        ek = s1 / p.seed_div;
        seed_t = tbf >= ek;
        seed_p = pbf >= ek;
        if (seed_p) lo_n = min(lo_n, -ek);
        if (seed_t) hi_n = max(hi_n, ek);
        if (all_null) {
          lo_n = seed_p ? -ek : (seed_t ? ek : 0);
          hi_n = seed_t ? ek : (seed_p ? -ek : 0);
          seeded_null = true;
        }
        null_step = false;
      }
    }
    const bool write = !null_step;
    const int klo = kmin + 2, khi = kmin + W - 3;
    const bool overflow = write && (lo_n < klo || hi_n > khi);
    lo_n = min(max(lo_n, klo), khi);
    hi_n = min(max(hi_n, klo), khi);
    prod[M] = write;
#pragma unroll
    for (int c = 1; c < kComps; ++c) prod[c] = prod[c] && write;

    // the cells: each component's value goes into its ring row of score
    // s + 1 untrimmed (no source row shares that slot), with the thread's
    // first and last in-bounds diagonal for the end trim. The narrow
    // kernel's one cell a thread waits in registers for the trim instead.
    int wmin[kComps], wmax[kComps];
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      wmin[c] = W;
      wmax[c] = -1;
    }
    int held[kComps], held_choice = 0;
    for (int w = w0; w < wend; w = kNarrow ? wend : w + T) {
      const int k = kmin + w;
      int arr[kComps];
      int choice, mval;
      if constexpr (kEditLike) {
        // every candidate comes from the wavefront of s
        int pm =
            max(pack(at_(mm, w + 1), 3), pack(at_(mm, w - 1) + 1, 1));
        if constexpr (kMetric == kEdit) {
          pm = max(pack(at_(mm, w) + 1, 5), pm);
        }
        // an all-invalid cell stays negative; the bounds check nulls it
        mval = pm >> 3;
        choice = one_comp_source(pm);
      } else if constexpr (kMetric == kLinear) {
        const int pm = max(pack(at_(mm, w) + 1, 5),
                           max(pack(at_(op, w + 1), 3),
                               pack(at_(op, w - 1) + 1, 1)));
        mval = pm < 0 ? kNull : (pm >> 3);
        choice = one_comp_source(pm);
      } else {
        int i1_ext, d1_ext;
        const int ins1 =
            gap_cell(at_(op, w - 1), at_(i1, w - 1), 1, &i1_ext);
        const int del1 =
            gap_cell(at_(op, w + 1), at_(d1, w + 1), 0, &d1_ext);
        const int mis = at_(mm, w) + 1;
        arr[I1] = ins1;
        arr[D1] = del1;
        // M by the packed (value << 3) | prio max
        int pm, raw;
        if constexpr (kMetric == kAffine2p) {
          int i2_ext, d2_ext;
          const int ins2 =
              gap_cell(at_(op2, w - 1), at_(i2, w - 1), 1, &i2_ext);
          const int del2 =
              gap_cell(at_(op2, w + 1), at_(d2, w + 1), 0, &d2_ext);
          arr[kComps - 2] = ins2;
          arr[kComps - 1] = del2;
          // X(5) > D2(4) > D1(3) > I2(2) > I1(1)
          pm = max(max(pack(mis, 5), pack(del2, 4)),
                   max(pack(del1, 3), max(pack(ins2, 2), pack(ins1, 1))));
          raw = max(max(mis, del2), max(del1, max(ins2, ins1)));
          const int pr = pm & 7;
          const int msrc =
              pm < 0 ? MSRC_NONE
                     : (pr == 5 ? MSRC_X
                                : (pr == 4 ? MSRC_D2
                                           : (pr == 3 ? MSRC_D1
                                                      : (pr == 2 ? MSRC_I2
                                                                 : MSRC_I1))));
          choice = msrc | (i1_ext << 3) | (d1_ext << 4) | (i2_ext << 5) |
                   (d2_ext << 6);
        } else {
          // X(5) > D1(3) > I1(1)
          pm = max(pack(mis, 5), max(pack(del1, 3), pack(ins1, 1)));
          raw = max(mis, max(del1, ins1));
          const int pr = pm & 7;
          const int msrc =
              pm < 0 ? MSRC_NONE
                     : (pr == 5 ? MSRC_X : (pr == 3 ? MSRC_D1 : MSRC_I1));
          choice = msrc | (i1_ext << 3) | (d1_ext << 4);
        }
        // an all-invalid cell keeps the largest raw candidate
        mval = pm < 0 ? raw : (pm >> 3);
      }
      if (mval < 0 || mval > tlen || mval - k < 0 || mval - k > plen) {
        mval = kNull;
      }
      if constexpr (kSeeding) {
        if (seed_t && k == ek && mval <= ek) {
          mval = ek;
          choice = MSRC_SEED;
        } else if (seed_p && k == -ek && mval <= 0) {
          mval = 0;
          choice = MSRC_SEED;
        }
      }
      arr[M] = mval;
      const bool bandn = k >= lo_n && k <= hi_n;
      const bool band_n = bandn && write;
#pragma unroll
      for (int c = 0; c < kComps; ++c) {
        if (!(band_n && prod[c])) arr[c] = kNull;
        const int v = arr[c] - k;
        if (bandn && arr[c] >= 0 && arr[c] <= tlen && v >= 0 && v <= plen) {
          wmin[c] = min(wmin[c], w);
          wmax[c] = max(wmax[c], w);
        }
        if (kNarrow) {
          held[c] = arr[c];
        } else {
          off[(p.base[c] + slot1[c]) * RS + w - wbase] = arr[c];
        }
      }
      if (kNarrow) {
        held_choice = band_n ? choice : 0;
      } else if (kRecord && band_n && choice != 0) {
        choices[static_cast<size_t>(s1 - seg_base) * BW + w] =
            static_cast<uint8_t>(choice);
      }
    }
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      red_ops.post_min(red + c * RR, wmin[c]);
      red_ops.post_max(red + (kComps + c) * RR, wmax[c]);
    }
    red_ops.sync();

    // end trim per component: the cells of the row outside the trimmed
    // band go back to NULL (each thread trims the cells it wrote); the
    // narrow kernel writes its cell now, trimmed
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      const int first = red_ops.fold_min(red + c * RR);
      const int last = red_ops.fold_max(red + (kComps + c) * RR);
      const bool keep = prod[c] && first < W;
      int tlo = keep ? first + kmin : 1;
      int thi = keep ? last + kmin : -1;
      if (kSeeding && c == M && seeded_null) {
        tlo = lo_n;
        thi = hi_n;
      }
      const int row = p.base[c] + slot1[c];
      if (kNarrow) {
        const int k = kmin + w0;
        off[row * RS + tid] = (k >= tlo && k <= thi) ? held[c] : kNull;
      } else if (tlo > lo_n || thi < hi_n || !keep) {
        for (int w = w0; w < wend; w = kNarrow ? wend : w + T) {
          const int k = kmin + w;
          if (k < tlo || k > thi) off[row * RS + w - wbase] = kNull;
        }
      }
      if (tid == 0) {
        lohi[2 * row] = tlo;
        lohi[2 * row + 1] = thi;
      }
      slot[c] = slot1[c];
      g_lo[c] = tlo;
      g_hi[c] = thi;
      if (c == M) {
        m_lo = tlo;
        m_hi = thi;
        // an empty edit or indel wavefront ends the pair at the next probe
        if (kEditLike && tlo > thi) nnull = kBig;
      }
    }

    if (kNarrow && kRecord && held_choice != 0) {
      choices[static_cast<size_t>(s1 - seg_base) * BW + w0] =
          static_cast<uint8_t>(held_choice);
    }

    // band overflow: the pair escalates to a wider band
    if (overflow) {
      status = ST_OVERFLOW_W;
      done = true;
    } else if (s1 >= p.max_steps) {
      status = ST_MAX_STEPS;
      final_s = s1;
      done = true;
    }
    s = s1;
  }
  // the cluster build: every CTA is past its last read of another's shared
  // memory before any leaves
  if constexpr (kCluster) red_ops.sync();
  if (carry != nullptr) {
    // the state of a later segment: a pair still running stays running
    // there, whatever its result says below
    if constexpr (!kCluster) __syncthreads();
    if (!ring_global) {
      for (int row = 0; row < p.rows; ++row) {
        for (int j = tid; j < RS; j += T) {
          ring_g[static_cast<size_t>(row) * W + wbase + j] = off[row * RS + j];
        }
      }
    }
    if (rank == 0) {
      int32_t* lg = p.lohi + static_cast<size_t>(b) * p.rows * 2;
      for (int i = tid; i < p.rows * 2; i += T) lg[i] = lohi[i];
    }
    if (tid == 0 && rank == 0) {
      carry[0] = s;
      carry[1] = status;
      carry[2] = final_s;
      carry[3] = end_k;
      carry[4] = end_off;
      carry[5] = nnull;
      carry[6] = h_wait;
      carry[7] = hm_sw;
      carry[8] = hm_k;
      carry[9] = hm_off;
      carry[10] = hm_valid ? 1 : 0;
      carry[11] = done ? 1 : 0;
    }
  }
  if (!done) {
    status = ST_OVERFLOW_S;
    final_s = s;
  }
  if (tid == 0 && rank == 0) {
    p.res[b] = status;
    p.res[p.B + b] = final_s;
    p.res[2 * p.B + b] = end_k;
    p.res[3 * p.B + b] = end_off;
  }
}

// The general kernel: a segment's state, the table, any band. Bounded to
// 64 registers a thread, so that every variant can launch the 1024
// threads a wide band asks for.
template <int kMetric, int kSpan, bool kRecord, bool kHeur>
__global__ void __launch_bounds__(1024) fused_loop(Params p) {
  loop_body<kMetric, kSpan, kRecord, kHeur, kBuildGeneral>(p);
}

// The narrow kernel of short reads (loop_body's kNarrow): fewer registers,
// so more blocks share an SM in a loop that waits on its barriers.
template <int kMetric, int kSpan, bool kRecord, bool kHeur>
__global__ void fused_loop_narrow(Params p) {
  loop_body<kMetric, kSpan, kRecord, kHeur, kBuildNarrow>(p);
}

// The cluster kernel of wide bands: a pair a cluster of Params::cluster
// CTAs (the launch's cluster dimension), a slice of at most 1024 diagonals
// a CTA, three a thread (pywfa_tpu_torch/ops/fused_loop.py::launch_shape),
// so at most kClusterThreads threads; bounded for two CTAs an SM, which
// leaves a thread 80 registers.
template <int kMetric, int kSpan, bool kRecord, bool kHeur>
__global__ void __launch_bounds__(kClusterThreads, 2)
    fused_loop_cluster(Params p) {
  loop_body<kMetric, kSpan, kRecord, kHeur, kBuildCluster>(p);
}

// --- the group build: G warps a pair, several pairs a block ---

// pairs a block of the group build, whatever G, and the threads of its
// largest block, the kernel's launch bound: eight warps, the most the
// routing gives (eight pairs of one warp, or one pair of up to eight)
// (pywfa_tpu_torch/ops/fused_loop.py::GROUP_MAX_PAIRS, GROUP_MAX_THREADS)
constexpr int kGroupMaxPairs = 8;
constexpr int kGroupMaxThreads = 256;
// named barriers a block may use besides id 0 (__syncthreads): one a pair
// when G > 1
constexpr int kNamedBarriers = 15;
constexpr int kExtChunks = 4;  // lanes' strides an extension pass loads

// rows of the group's fold partials (G > 1), in a pair's shared memory:
// the trim's 2 * kComps, then the ends-free first hit, then the cascade's
constexpr int kRowTerm = 2 * kMaxComps;
constexpr int kRowHeur = kRowTerm + 1;

// ints of shared memory one pair of the group build takes: its ring
// [rows][W] and its lo/hi pairs [rows][2]; with G > 1 warps a pair also
// `partials` rows of G fold partials and two slots of the next pair's
// index; rounded up to whole int4s so that the next pair's ring starts
// 16-byte aligned (pywfa_tpu_torch/ops/fused_loop.py::group_pair_bytes)
__host__ __device__ constexpr int group_pair_ints(int rows, int W, int G,
                                                  int partials) {
  return (rows * (W + 2) + (G > 1 ? partials * G + 2 : 0) + 3) & ~3;
}

// The threads of one pair: G warps, t = 32 * (warp in the group) + lane.
// Every per-cell pass strides by GT = 32 * G. With G == 1 (a branch
// uniform over the launch) a fold is one __reduce_*_sync and a barrier a
// __syncwarp; with G > 1 a fold is a warp
// reduction, lane 0 of each warp posting its partial into the pair's row
// `row` of `red`, the group's named barrier (bar.sync 1 + the pair's slot
// in the block, GT threads; id 0 stays __syncthreads; a __syncwarp first,
// so that every warp arrives converged, as the aligned form wants), then
// every warp
// folding the G partials with one more warp reduction. A row is posted
// again only after a later barrier of the group, so no fold reads a
// partial of the next use.
struct Group {
  int t, lane, g, G, GT, bar;
  int* red;  // [partials][G] (G > 1)

  __device__ __forceinline__ void sync() const {
    if (G == 1) {
      __syncwarp();
    } else {
      __syncwarp();
      asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(GT) : "memory");
    }
  }
  __device__ __forceinline__ void post_min(int row, int v) const {
    v = __reduce_min_sync(kFull, v);
    if (lane == 0) red[row * G + g] = v;
  }
  __device__ __forceinline__ void post_max(int row, int v) const {
    v = __reduce_max_sync(kFull, v);
    if (lane == 0) red[row * G + g] = v;
  }
  __device__ __forceinline__ int fold_min(int row) const {
    return __reduce_min_sync(kFull, lane < G ? red[row * G + lane] : kBig);
  }
  __device__ __forceinline__ int fold_max(int row) const {
    return __reduce_max_sync(kFull, lane < G ? red[row * G + lane] : -kBig);
  }
  // a whole reduction over the pair's threads
  __device__ __forceinline__ int reduce_min(int row, int v) const {
    if (G == 1) return __reduce_min_sync(kFull, v);
    post_min(row, v);
    sync();
    return fold_min(row);
  }
  __device__ __forceinline__ int reduce_max(int row, int v) const {
    if (G == 1) return __reduce_max_sync(kFull, v);
    post_max(row, v);
    sync();
    return fold_max(row);
  }
};

// The wavefront of component `comp` at score s1 - dist in the group
// build's ring, as read_wf reads it, with no test for a negative score:
// there every row holds NULL outside its band, and the row of a negative
// score (slot s1 - dist + depth, a score not reached yet) was never
// written, so it is all NULL and its band empty. The compute reads its
// cells as row[w - 1], row[w], row[w + 1] with no bounds test: its
// diagonals lie in [kmin + 2, kmin + W - 3], their neighbours in [0, W).
__device__ __forceinline__ Wf ring_wf(const int* off, const int* lohi,
                                      const Params& p, int comp, int slot1,
                                      int dist, int W) {
  int j = slot1 - dist;
  if (j < 0) j += p.depth[comp];
  const int i = p.base[comp] + j;
  Wf f;
  f.row = off + i * W;
  f.lo = lohi[2 * i];
  f.hi = lohi[2 * i + 1];
  f.null_ = f.lo > f.hi;
  return f;
}

// Set to NULL the cells of a ring row in [lo, hi] (diagonals, w = k - kmin)
// that lie outside [keep_lo, keep_hi]: the two flanks [lo, keep_lo - 1]
// and [keep_hi + 1, hi] (which cover all of [lo, hi] when the kept band is
// empty, keep_lo > keep_hi), one thread a diagonal, GT at a time, so a
// step whose band barely moves writes a stride or two however wide the
// band.
__device__ __forceinline__ void null_outside(int* row, int lo, int hi,
                                             int keep_lo, int keep_hi,
                                             int kmin, const Group& grp) {
  const int left_hi = min(hi, keep_lo - 1);
  for (int k = lo + grp.t; k <= left_hi; k += grp.GT) row[k - kmin] = kNull;
  for (int k = max(lo, keep_hi + 1) + grp.t; k <= hi; k += grp.GT) {
    row[k - kmin] = kNull;
  }
}

// The loop of one pair on one group of G warps: one shot or a segment, on
// the words, the run-length table or the rows, the ring in shared memory,
// as loop_body computes it, cell for cell. Every per-cell pass runs over
// the live band only, GT diagonals a stride (thread t owns k = k0 + t), and
// folds its minima and maxima in registers, one group reduction a pass
// (Group). The invariant that replaces writing all W cells a step: every
// cell of a ring row outside the row's band is NULL. WF0 fills the whole
// ring with NULL once; a step nulls, in the recycled row of s + 1, what its
// old band (score s + 1 - depth) and the untrimmed new band hold outside
// the trimmed one; the cascade's install nulls what it cuts. Out-of-band
// cells then read NULL as before, and the two folds of the cascade that
// saw every diagonal of [0, W) keep their value: the band never covers
// w = 0 (klo = kmin + 2), so wf-adaptive folds max(plen, tlen) once, and
// x-drop / z-drop take diagonal 0 (w = 0) as the maximum's index when no
// cell of the band is valid.
//
// Barriers a step, with G > 1: two. One after the extension (it carries
// the ends-free first hit's partials, and orders the extension's cells
// and the last step's trim before the termination, the cascade and the
// compute read them), one after the compute of s + 1 (it carries the
// 2 * kComps trim bounds, posted together). The trim's writes need none
// of their own: they null cells outside the trimmed bands and set the
// bands, which the next step's extension does not touch (it reads and
// writes M's cells inside its band) and everything after it reads behind
// that step's first barrier. The cascade adds one a fold and two around
// its install, on the steps it cuts. With G == 1 a step keeps its three
// __syncwarp.
template <int kMetric, int kSpan, bool kRecord, bool kHeur>
__device__ __forceinline__ void group_pair(const Params& p, int b, int* off,
                                           const Group& grp) {
  constexpr int kComps = n_comps(kMetric);
  constexpr bool kEditLike = kMetric == kEdit || kMetric == kIndel;
  constexpr bool kEndsFree = kSpan != kEndToEnd;
  constexpr bool kSeeding = kSpan == kSeeded;
  const int W = p.W;
  const int RS = W;
  const int scope = p.scope;
  const int kmin = -(W / 2);
  const int klo = kmin + 2, khi = kmin + W - 3;
  const int t = grp.t, GT = grp.GT;
  const bool one = grp.G == 1;
  // this pair's ring [rows][W] and bands [rows][2]
  int* lohi = off + p.rows * W;
  const int plen = p.plen[b];
  const int tlen = p.tlen[b];
  const size_t BW = static_cast<size_t>(p.B) * W;
  const size_t bW = static_cast<size_t>(b) * W;
  const uint32_t* bits = p.bits == nullptr ? nullptr : p.bits + bW;
  const uint8_t* table8 =
      p.table == nullptr
          ? nullptr
          : static_cast<const uint8_t*>(p.table) + (p.table_u8 ? bW : 2 * bW);
  uint8_t* choices = kRecord ? p.choices + bW : nullptr;
  const int NQ32 = p.NQ * 32;
  const int seg_base = p.seg_base;
  const int seg_end = seg_base + p.S_cap - 1;
  // the state of a segmented run: this pair's ring [rows][W] and carry
  int4* ring_g = p.ring == nullptr
                     ? nullptr
                     : reinterpret_cast<int4*>(
                           p.ring + static_cast<size_t>(b) * p.rows * W);
  int32_t* carry =
      p.carry == nullptr ? nullptr : p.carry + static_cast<size_t>(b) * kCarry;
  int4* off4 = reinterpret_cast<int4*>(off);

  int pbf = 0, pef = 0, tbf = 0, tef = 0;
  if (kEndsFree) {
    const int32_t* fr = p.frees + 4 * static_cast<size_t>(b);
    pbf = fr[0];
    pef = fr[1];
    tbf = fr[2];
    tef = fr[3];
  }

  // group-uniform state, as loop_body's block-uniform state
  int s = 0, status = 0, final_s = 0, end_k = 0, end_off = kNull;
  int nnull = 0;
  int h_wait = p.steps_between;
  int hm_sw = 0, hm_k = 0, hm_off = kNull;
  bool hm_valid = false;
  bool done = false;
  if (p.fresh) {
    // WF0 (see loop_body)
    int wf0_lo = 0, wf0_hi = 0;
    if (kSpan == kEndsFreeWf0) {
      wf0_lo = -pbf;
      wf0_hi = tbf;
    }
    done = kSpan == kEndsFreeWf0 && (wf0_lo < klo || wf0_hi > khi);
    if (done) status = ST_OVERFLOW_W;
    const int4 null4 = make_int4(kNull, kNull, kNull, kNull);
    for (int i = t; i < p.rows * W / 4; i += GT) off4[i] = null4;
    for (int i = t; i < p.rows; i += GT) {
      lohi[2 * i] = (i == 0) ? wf0_lo : 1;
      lohi[2 * i + 1] = (i == 0) ? wf0_hi : -1;
    }
    grp.sync();
    // the seeds inside [0, W) (a pair done at WF0 still stores its state)
    for (int k = max(wf0_lo, kmin) + t; k <= min(wf0_hi, kmin + W - 1);
         k += GT) {
      off[k - kmin] = max(k, 0);
    }
  } else {
    // a later segment: the carry, the bands and the ring from the state
    s = carry[0];
    status = carry[1];
    final_s = carry[2];
    end_k = carry[3];
    end_off = carry[4];
    nnull = carry[5];
    h_wait = carry[6];
    hm_sw = carry[7];
    hm_k = carry[8];
    hm_off = carry[9];
    hm_valid = carry[10] != 0;
    if (carry[11] != 0) {
      // a pair that is done: its result again, its state untouched
      if (t == 0) {
        p.res[b] = status;
        p.res[p.B + b] = final_s;
        p.res[2 * p.B + b] = end_k;
        p.res[3 * p.B + b] = end_off;
      }
      return;
    }
    // the ring in coalesced 16-byte loads (W is a multiple of 32)
    for (int i = t; i < p.rows * W / 4; i += GT) off4[i] = ring_g[i];
    const int32_t* lg = p.lohi + static_cast<size_t>(b) * p.rows * 2;
    for (int i = t; i < p.rows * 2; i += GT) lohi[i] = lg[i];
  }
  grp.sync();

  // each component's ring slot of score s (s % depth) and the band of its
  // row of score s (M owns rows [0, scope))
  int slot[kComps], g_lo[kComps], g_hi[kComps];
#pragma unroll
  for (int c = 0; c < kComps; ++c) {
    slot[c] = s % p.depth[c];
    const int row = p.base[c] + slot[c];
    g_lo[c] = lohi[2 * row];
    g_hi[c] = lohi[2 * row + 1];
  }
  int m_lo = g_lo[M], m_hi = g_hi[M];

  while (!done && s < seg_end) {
    int* m_row = off + slot[M] * W;
    const bool m_null = m_lo > m_hi;
    if (m_null && nnull > scope) {
      status = ST_END_UNREACHABLE;
      final_s = s;
      done = true;
      break;
    }

    // --- extension over M's band, by the equality words, the run-length
    // table or the token rows (a branch uniform over the launch, outside
    // the passes) ---
    // up to kExtChunks strides at a time, as many as the band reaches:
    // their first words (or their runs) are loaded together, so a wide
    // band waits on one load latency, not one a stride
    int first_hit = W;
    // a cell on an end-free boundary (see loop_body): the lowest wins
    auto end_hit = [&](int k, int w, int mo) {
      const int v = mo - k;
      if (k <= m_hi && mo > kNullThreshold &&
          ((mo >= tlen && plen - v <= pef) ||
           (v >= plen && tlen - mo <= tef))) {
        first_hit = min(first_hit, w);
      }
    };
    if (!m_null && table8 != nullptr) {
      const int16_t* table16 = reinterpret_cast<const int16_t*>(table8);
      for (int k0 = m_lo; k0 <= m_hi; k0 += GT * kExtChunks) {
        int m_off[kExtChunks], run[kExtChunks];
#pragma unroll
        for (int j = 0; j < kExtChunks; ++j) {
          if (j > 0 && k0 + GT * j > m_hi) break;
          const int k = k0 + GT * j + t;
          m_off[j] = k <= m_hi ? m_row[k - kmin] : kNull;
          const size_t at_h =
              static_cast<size_t>(min(m_off[j], p.Ltp - 1)) * BW + (k - kmin);
          run[j] = !(m_off[j] >= 0 && m_off[j] <= tlen) ? 0
                   : p.table_u8 ? static_cast<int>(__ldg(table8 + at_h))
                                : static_cast<int>(__ldg(table16 + at_h));
        }
#pragma unroll
        for (int j = 0; j < kExtChunks; ++j) {
          if (j > 0 && k0 + GT * j > m_hi) break;
          const int k = k0 + GT * j + t;
          const int w = k - kmin;
          int mo = m_off[j];
          if (mo >= 0 && mo <= tlen) {
            mo += run[j];
            m_row[w] = mo;
          }
          if (kEndsFree) end_hit(k, w, mo);
        }
      }
    } else if (!m_null && p.pat != nullptr) {
      // the rows compared in place, a cell at a time (chunk_run)
      for (int k = m_lo + t; k <= m_hi; k += GT) {
        const int w = k - kmin;
        int mo = m_row[w];
        if (mo >= 0 && mo <= tlen) {
          mo += chunk_run(p, b, mo - k, mo, plen, tlen);
          m_row[w] = mo;
        }
        if (kEndsFree) end_hit(k, w, mo);
      }
    } else if (!m_null) {
      for (int k0 = m_lo; k0 <= m_hi; k0 += GT * kExtChunks) {
        int m_off[kExtChunks], idx[kExtChunks];
        uint32_t mq[kExtChunks];
#pragma unroll
        for (int j = 0; j < kExtChunks; ++j) {
          if (j > 0 && k0 + GT * j > m_hi) break;
          const int k = k0 + GT * j + t;
          m_off[j] = k <= m_hi ? m_row[k - kmin] : kNull;
          idx[j] = min(m_off[j], NQ32 - 1);
          mq[j] = (m_off[j] >= 0 && m_off[j] <= tlen)
                      ? ~__ldg(bits + (idx[j] >> 5) * BW + (k - kmin)) &
                            (0xFFFFFFFFu << (idx[j] & 31))
                      : 0u;
        }
#pragma unroll
        for (int j = 0; j < kExtChunks; ++j) {
          if (j > 0 && k0 + GT * j > m_hi) break;
          const int k = k0 + GT * j + t;
          const int w = k - kmin;
          int mo = m_off[j];
          if (mo >= 0 && mo <= tlen) {
            int q = idx[j] >> 5;
            uint32_t m = mq[j];
            while (m == 0 && ++q < p.NQ) m = ~__ldg(bits + q * BW + w);
            const int fm =
                (m != 0) ? q * 32 + __ffs(static_cast<int>(m)) - 1 : NQ32;
            mo += fm - idx[j];
            m_row[w] = mo;
          }
          if (kEndsFree) end_hit(k, w, mo);
        }
      }
    }
    // the step's first barrier, with the first hit's partials
    if (kEndsFree && !one) grp.post_min(kRowTerm, first_hit);
    grp.sync();

    // --- termination ---
    if (kEndsFree) {
      const int first = one ? __reduce_min_sync(kFull, first_hit)
                            : grp.fold_min(kRowTerm);
      if (first < W) {
        status = ST_END_REACHED;
        final_s = s;
        end_k = first + kmin;
        end_off = m_row[first];
        done = true;
        break;
      }
    } else {
      const int ak = tlen - plen;
      if (!m_null && m_lo <= ak && ak <= m_hi && m_row[ak - kmin] >= tlen) {
        status = ST_END_REACHED;
        final_s = s;
        end_k = ak;
        end_off = tlen;
        done = true;
        break;
      }
    }

    // --- heuristic cascade (see loop_body), over the band ---
    if constexpr (kHeur) {
      if (!m_null) {
        --h_wait;
        int cur_lo = m_lo, cur_hi = m_hi;
        const int st = p.strategy;
        if ((st & (kWfAdaptive | kWfMash)) && h_wait <= 0 &&
            cur_hi - cur_lo + 1 >= p.min_wf_len) {
          const float mfactor = __fdiv_rn(__int2float_rn(plen + tlen), 2.0f);
          auto dist_of = [&](int k, int m_off) {
            if (m_off < 0) return -kNull;
            const int v = m_off - k;
            if (st & kWfMash) {
              return max(mash_dist(plen - v, plen, mfactor),
                         mash_dist(tlen - m_off, tlen, mfactor));
            }
            return max(plen - v, tlen - m_off);
          };
          // the diagonals outside the band count max(plen, tlen): w = 0
          // always is one
          int mn = max(plen, tlen);
          for (int k0 = cur_lo; k0 <= cur_hi; k0 += GT) {
            const int k = k0 + t;
            if (k <= cur_hi) mn = min(mn, dist_of(k, m_row[k - kmin]));
          }
          const int mind = grp.reduce_min(kRowHeur, mn);
          const int ak = tlen - plen;
          const int top_limit = min(ak, cur_hi);
          int f = W, l = -1;
          for (int k0 = cur_lo; k0 <= cur_hi; k0 += GT) {
            const int k = k0 + t;
            const int w = k - kmin;
            const bool keep =
                k <= cur_hi && dist_of(k, m_row[w]) - mind <= p.max_dist;
            if (keep && k < top_limit) f = min(f, w);
            if (keep && k > ak) l = max(l, w);
          }
          int first, last;
          if (one) {
            first = __reduce_min_sync(kFull, f);
            last = __reduce_max_sync(kFull, l);
          } else {
            grp.post_min(kRowHeur + 1, f);
            grp.post_max(kRowHeur + 2, l);
            grp.sync();
            first = grp.fold_min(kRowHeur + 1);
            last = grp.fold_max(kRowHeur + 2);
          }
          const int lo_red = first < W ? first + kmin : max(top_limit, cur_lo);
          const int new_lo = max(lo_red, cur_lo);
          const int bot_limit = max(ak, new_lo);
          const int hi_red = (last >= 0 && last + kmin > bot_limit)
                                 ? last + kmin
                                 : min(bot_limit, cur_hi);
          cur_hi = min(hi_red, cur_hi);
          cur_lo = new_lo;
          h_wait = p.steps_between;
        }
        if ((st & (kXdrop | kZdrop)) && h_wait <= 0) {
          auto sw_of = [&](int k, int m_off) {
            return m_off >= 0 ? (p.swg_match * (m_off - k + m_off) - s) / 2
                              : -kBig;
          };
          int mx = -kBig;
          for (int k0 = cur_lo; k0 <= cur_hi; k0 += GT) {
            const int k = k0 + t;
            if (k <= cur_hi) mx = max(mx, sw_of(k, m_row[k - kmin]));
          }
          const int cmax = grp.reduce_max(kRowHeur + 3, mx);
          const bool xd = (st & kXdrop) != 0;
          int ci = W, fx = W, lx = -1;
          for (int k0 = cur_lo; k0 <= cur_hi; k0 += GT) {
            const int k = k0 + t;
            const int w = k - kmin;
            const int sw = k <= cur_hi ? sw_of(k, m_row[w]) : -kBig;
            if (sw == cmax) ci = min(ci, w);
            if (xd && sw > -kBig && hm_sw - sw < p.xdrop) {
              fx = min(fx, w);
              lx = max(lx, w);
            }
          }
          // the maximum's first diagonal, and x-drop's kept span, in one
          // fold
          int ci_band, firstx = W, lastx = -1;
          if (one) {
            ci_band = __reduce_min_sync(kFull, ci);
            if (xd) {
              firstx = __reduce_min_sync(kFull, fx);
              lastx = __reduce_max_sync(kFull, lx);
            }
          } else {
            grp.post_min(kRowHeur + 4, ci);
            if (xd) {
              grp.post_min(kRowHeur + 5, fx);
              grp.post_max(kRowHeur + 6, lx);
            }
            grp.sync();
            ci_band = grp.fold_min(kRowHeur + 4);
            if (xd) {
              firstx = grp.fold_min(kRowHeur + 5);
              lastx = grp.fold_max(kRowHeur + 6);
            }
          }
          // no valid cell in the band: every diagonal scores -kBig, and
          // the first of them is w = 0
          const int cidx = cmax == -kBig ? 0 : ci_band;
          const bool improved = !hm_valid || cmax > hm_sw;
          if (xd) {
            if (hm_valid) {
              cur_lo = firstx < W ? firstx + kmin : cur_hi + 1;
              cur_hi = firstx < W ? lastx + kmin : cur_lo - 1;
            }
            if (improved) {
              hm_sw = cmax;
              hm_k = cidx + kmin;
            }
          } else {
            const bool zdropped =
                hm_valid && !improved && hm_sw - cmax > p.zdrop;
            if (improved) {
              hm_sw = cmax;
              hm_k = cidx + kmin;
              hm_off = m_row[min(cidx, W - 1)];
            }
            if (zdropped) {
              status = ST_END_UNREACHABLE;
              final_s = s;
              end_k = hm_k;
              end_off = hm_off;
              done = true;
              break;
            }
          }
          hm_valid = true;
          h_wait = p.steps_between;
        }
        if (st & kBandedStatic) {
          cur_lo = max(cur_lo, p.band_min_k);
          cur_hi = min(cur_hi, p.band_max_k);
        } else if (st & kBandedAdaptive) {
          const int wf_len = cur_hi - cur_lo + 1;
          const int max_len = p.band_max_k - p.band_min_k + 1;
          if (h_wait <= 0 && wf_len >= 4) {
            if (wf_len > max_len) {
              auto dist_at = [&](int kq) {
                const int o = m_row[min(max(kq - kmin, 0), W - 1)];
                return o >= 0 ? max(plen - (o - kq), tlen - o) : -kNull;
              };
              const int leeway = (wf_len - max_len) / 2;
              const int quarter = wf_len / 4;
              const int d0 = dist_at(cur_lo);
              const int d1 = dist_at(cur_lo + quarter);
              const int d2 = dist_at(cur_lo + 2 * quarter);
              const int d3 = dist_at(cur_hi);
              const int new_lo0 = cur_lo + (d0 > d3 ? leeway : 0) +
                                  (d1 > d2 ? leeway : 0);
              cur_hi = min(new_lo0 + max_len - 1, cur_hi);
              cur_lo = max(new_lo0, cur_lo);
            }
            h_wait = p.steps_between;
          }
        }
        if (cur_lo != m_lo || cur_hi != m_hi) {
          // install M's pruned band and cut every gap component's row of
          // score s to it: null what each row's old band loses, after
          // every thread's reads of M's row above (the banded-adaptive cut
          // reads cells that the install nulls)
          grp.sync();
          null_outside(m_row, m_lo, m_hi, cur_lo, cur_hi, kmin, grp);
#pragma unroll
          for (int c = 1; c < kComps; ++c) {
            const int nlo = max(g_lo[c], cur_lo);
            const int nhi = min(g_hi[c], cur_hi);
            null_outside(off + (p.base[c] + slot[c]) * W, g_lo[c], g_hi[c],
                         nlo, nhi, kmin, grp);
            g_lo[c] = nlo;
            g_hi[c] = nhi;
          }
          if (t == 0) {
            lohi[2 * slot[M]] = cur_lo;
            lohi[2 * slot[M] + 1] = cur_hi;
#pragma unroll
            for (int c = 1; c < kComps; ++c) {
              const int row = p.base[c] + slot[c];
              lohi[2 * row] = g_lo[c];
              lohi[2 * row + 1] = g_hi[c];
            }
          }
          grp.sync();
        }
      }
    }

    // --- compute s + 1 (see loop_body) ---
    const int s1 = s + 1;
    int slot1[kComps], old_lo[kComps], old_hi[kComps];
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      slot1[c] = slot[c] + 1 == p.depth[c] ? 0 : slot[c] + 1;
      // the band of score s + 1 - depth that this row still holds
      const int row = p.base[c] + slot1[c];
      old_lo[c] = lohi[2 * row];
      old_hi[c] = lohi[2 * row + 1];
    }
    Wf mm, op, i1, d1, op2, i2, d2;
    bool prod[kComps];
    int lo_n, hi_n;
    bool all_null;
    if constexpr (kEditLike) {
      mm = ring_wf(off, lohi, p, M, slot1[M], 1, W);
      lo_n = mm.lo - 1;
      hi_n = mm.hi + 1;
      all_null = mm.null_;
    } else if constexpr (kMetric == kLinear) {
      mm = ring_wf(off, lohi, p, M, slot1[M], p.x, W);
      op = ring_wf(off, lohi, p, M, slot1[M], p.o1, W);
      lo_n = min(lim_lo(mm, 0), lim_lo(op, 1));
      hi_n = max(lim_hi(mm, 0), lim_hi(op, 1));
      all_null = mm.null_ && op.null_;
    } else {
      mm = ring_wf(off, lohi, p, M, slot1[M], p.x, W);
      op = ring_wf(off, lohi, p, M, slot1[M], p.o1, W);
      i1 = ring_wf(off, lohi, p, I1, slot1[I1], p.e1, W);
      d1 = ring_wf(off, lohi, p, D1, slot1[D1], p.e1, W);
      lo_n = min(min(lim_lo(mm, 0), lim_lo(op, 1)),
                 min(lim_lo(i1, 1), lim_lo(d1, 1)));
      hi_n = max(max(lim_hi(mm, 0), lim_hi(op, 1)),
                 max(lim_hi(i1, 1), lim_hi(d1, 1)));
      all_null = mm.null_ && op.null_ && i1.null_ && d1.null_;
      prod[I1] = !(op.null_ && i1.null_);
      prod[D1] = !(op.null_ && d1.null_);
      if constexpr (kMetric == kAffine2p) {
        op2 = ring_wf(off, lohi, p, M, slot1[M], p.o2, W);
        i2 = ring_wf(off, lohi, p, I2, slot1[kComps - 2], p.e2, W);
        d2 = ring_wf(off, lohi, p, D2, slot1[kComps - 1], p.e2, W);
        lo_n = min(lo_n, min(lim_lo(op2, 1),
                             min(lim_lo(i2, 1), lim_lo(d2, 1))));
        hi_n = max(hi_n, max(lim_hi(op2, 1),
                             max(lim_hi(i2, 1), lim_hi(d2, 1))));
        all_null = all_null && op2.null_ && i2.null_ && d2.null_;
        prod[kComps - 2] = !(op2.null_ && i2.null_);
        prod[kComps - 1] = !(op2.null_ && d2.null_);
      }
    }
    if (!kEditLike) nnull = all_null ? nnull + 1 : 0;
    bool null_step = all_null, seeded_null = false;
    bool seed_t = false, seed_p = false;
    int ek = 0;
    if constexpr (kSeeding) {
      if (s1 % p.seed_div == 0 && (pbf > 0 || tbf > 0)) {
        ek = s1 / p.seed_div;
        seed_t = tbf >= ek;
        seed_p = pbf >= ek;
        if (seed_p) lo_n = min(lo_n, -ek);
        if (seed_t) hi_n = max(hi_n, ek);
        if (all_null) {
          lo_n = seed_p ? -ek : (seed_t ? ek : 0);
          hi_n = seed_t ? ek : (seed_p ? -ek : 0);
          seeded_null = true;
        }
        null_step = false;
      }
    }
    const bool write = !null_step;
    const bool overflow = write && (lo_n < klo || hi_n > khi);
    lo_n = min(max(lo_n, klo), khi);
    hi_n = min(max(hi_n, klo), khi);
    prod[M] = write;
#pragma unroll
    for (int c = 1; c < kComps; ++c) prod[c] = prod[c] && write;

    // the cells of [lo_n, hi_n], untrimmed, into each component's row of
    // s + 1 (no source row shares that slot), with each thread's first and
    // last in-bounds diagonal for the trim; two strides an iteration, the
    // source cells of both read before either's cells are written, so that
    // their loads and their arithmetic overlap
    int wmin[kComps], wmax[kComps];
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      wmin[c] = W;
      wmax[c] = -1;
    }
    constexpr int kSrc =
        (kEditLike || kMetric == kLinear) ? 3 : (kMetric == kAffine ? 5 : 9);
    // the source cells of diagonal w: the neighbours the compute reads
    auto gather = [&](int w, int* v) {
      if constexpr (kEditLike) {
        v[0] = mm.row[w + 1];
        v[1] = mm.row[w - 1];
        v[2] = mm.row[w];
      } else if constexpr (kMetric == kLinear) {
        v[0] = mm.row[w];
        v[1] = op.row[w + 1];
        v[2] = op.row[w - 1];
      } else {
        v[0] = op.row[w - 1];
        v[1] = i1.row[w - 1];
        v[2] = op.row[w + 1];
        v[3] = d1.row[w + 1];
        v[4] = mm.row[w];
        if constexpr (kMetric == kAffine2p) {
          v[5] = op2.row[w - 1];
          v[6] = i2.row[w - 1];
          v[7] = op2.row[w + 1];
          v[8] = d2.row[w + 1];
        }
      }
    };
    // diagonal k's cells of s + 1 from its source cells v
    auto compute = [&](int k, const int* v) {
      const int w = k - kmin;
      int arr[kComps];
      int choice, mval;
      if constexpr (kEditLike) {
        int pm = max(pack(v[0], 3), pack(v[1] + 1, 1));
        if constexpr (kMetric == kEdit) {
          pm = max(pack(v[2] + 1, 5), pm);
        }
        mval = pm >> 3;
        choice = one_comp_source(pm);
      } else if constexpr (kMetric == kLinear) {
        const int pm = max(pack(v[0] + 1, 5),
                           max(pack(v[1], 3), pack(v[2] + 1, 1)));
        mval = pm < 0 ? kNull : (pm >> 3);
        choice = one_comp_source(pm);
      } else {
        int i1_ext, d1_ext;
        const int ins1 = gap_cell(v[0], v[1], 1, &i1_ext);
        const int del1 = gap_cell(v[2], v[3], 0, &d1_ext);
        const int mis = v[4] + 1;
        arr[I1] = ins1;
        arr[D1] = del1;
        int pm, raw;
        if constexpr (kMetric == kAffine2p) {
          int i2_ext, d2_ext;
          const int ins2 = gap_cell(v[5], v[6], 1, &i2_ext);
          const int del2 = gap_cell(v[7], v[8], 0, &d2_ext);
          arr[kComps - 2] = ins2;
          arr[kComps - 1] = del2;
          pm = max(max(pack(mis, 5), pack(del2, 4)),
                   max(pack(del1, 3), max(pack(ins2, 2), pack(ins1, 1))));
          raw = max(max(mis, del2), max(del1, max(ins2, ins1)));
          const int pr = pm & 7;
          const int msrc =
              pm < 0 ? MSRC_NONE
                     : (pr == 5 ? MSRC_X
                                : (pr == 4 ? MSRC_D2
                                           : (pr == 3 ? MSRC_D1
                                                      : (pr == 2 ? MSRC_I2
                                                                 : MSRC_I1))));
          choice = msrc | (i1_ext << 3) | (d1_ext << 4) | (i2_ext << 5) |
                   (d2_ext << 6);
        } else {
          pm = max(pack(mis, 5), max(pack(del1, 3), pack(ins1, 1)));
          raw = max(mis, max(del1, ins1));
          const int pr = pm & 7;
          const int msrc =
              pm < 0 ? MSRC_NONE
                     : (pr == 5 ? MSRC_X : (pr == 3 ? MSRC_D1 : MSRC_I1));
          choice = msrc | (i1_ext << 3) | (d1_ext << 4);
        }
        mval = pm < 0 ? raw : (pm >> 3);
      }
      if (mval < 0 || mval > tlen || mval - k < 0 || mval - k > plen) {
        mval = kNull;
      }
      if constexpr (kSeeding) {
        if (seed_t && k == ek && mval <= ek) {
          mval = ek;
          choice = MSRC_SEED;
        } else if (seed_p && k == -ek && mval <= 0) {
          mval = 0;
          choice = MSRC_SEED;
        }
      }
      arr[M] = mval;
#pragma unroll
      for (int c = 0; c < kComps; ++c) {
        if (!prod[c]) arr[c] = kNull;
        const int d = arr[c] - k;
        if (arr[c] >= 0 && arr[c] <= tlen && d >= 0 && d <= plen) {
          wmin[c] = min(wmin[c], w);
          wmax[c] = max(wmax[c], w);
        }
        off[(p.base[c] + slot1[c]) * W + w] = arr[c];
      }
      if (kRecord && choice != 0) {
        choices[static_cast<size_t>(s1 - seg_base) * BW + w] =
            static_cast<uint8_t>(choice);
      }
    };
    for (int k0 = lo_n; write && k0 <= hi_n; k0 += 2 * GT) {
      const int ka = k0 + t, kb = ka + GT;
      int va[kSrc], vb[kSrc];
      if (ka <= hi_n) gather(ka - kmin, va);
      if (kb <= hi_n) gather(kb - kmin, vb);
      if (ka <= hi_n) compute(ka, va);
      if (kb <= hi_n) compute(kb, vb);
    }
    // the step's second barrier, with the 2 * kComps trim bounds
    if (!one) {
#pragma unroll
      for (int c = 0; c < kComps; ++c) {
        grp.post_min(c, wmin[c]);
        grp.post_max(kComps + c, wmax[c]);
      }
    }
    grp.sync();

    // end trim per component: of the row's old band and of the cells just
    // written, what lies outside the trimmed band goes back to NULL
    int t_lo[kComps], t_hi[kComps];
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      const int first = one ? __reduce_min_sync(kFull, wmin[c])
                            : grp.fold_min(c);
      const int last = one ? __reduce_max_sync(kFull, wmax[c])
                           : grp.fold_max(kComps + c);
      const bool keep = prod[c] && first < W;
      int tlo = keep ? first + kmin : 1;
      int thi = keep ? last + kmin : -1;
      if (kSeeding && c == M && seeded_null) {
        tlo = lo_n;
        thi = hi_n;
      }
      int lo_x = old_lo[c] <= old_hi[c] ? old_lo[c] : kBig;
      int hi_x = old_lo[c] <= old_hi[c] ? old_hi[c] : -kBig;
      if (write) {
        lo_x = min(lo_x, lo_n);
        hi_x = max(hi_x, hi_n);
      }
      null_outside(off + (p.base[c] + slot1[c]) * W, lo_x, hi_x, tlo, thi,
                   kmin, grp);
      t_lo[c] = tlo;
      t_hi[c] = thi;
      slot[c] = slot1[c];
      g_lo[c] = tlo;
      g_hi[c] = thi;
      if (c == M) {
        m_lo = tlo;
        m_hi = thi;
        if (kEditLike && tlo > thi) nnull = kBig;
      }
    }
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < kComps; ++c) {
        const int row = p.base[c] + slot1[c];
        lohi[2 * row] = t_lo[c];
        lohi[2 * row + 1] = t_hi[c];
      }
    }
    if (one) __syncwarp();

    if (overflow) {
      status = ST_OVERFLOW_W;
      done = true;
    } else if (s1 >= p.max_steps) {
      status = ST_MAX_STEPS;
      final_s = s1;
      done = true;
    }
    s = s1;
  }
  if (carry != nullptr) {
    // the state, byte for byte the general build's: a pair still running
    // stays running there, whatever its result says below
    grp.sync();
    for (int i = t; i < p.rows * W / 4; i += GT) ring_g[i] = off4[i];
    int32_t* lg = p.lohi + static_cast<size_t>(b) * p.rows * 2;
    for (int i = t; i < p.rows * 2; i += GT) lg[i] = lohi[i];
    if (t == 0) {
      carry[0] = s;
      carry[1] = status;
      carry[2] = final_s;
      carry[3] = end_k;
      carry[4] = end_off;
      carry[5] = nnull;
      carry[6] = h_wait;
      carry[7] = hm_sw;
      carry[8] = hm_k;
      carry[9] = hm_off;
      carry[10] = hm_valid ? 1 : 0;
      carry[11] = done ? 1 : 0;
    }
  }
  if (!done) {
    status = ST_OVERFLOW_S;
    final_s = s;
  }
  if (t == 0) {
    p.res[b] = status;
    p.res[p.B + b] = final_s;
    p.res[2 * p.B + b] = end_k;
    p.res[3 * p.B + b] = end_off;
  }
}

// A persistent grid of groups, as many as the SMs hold at once: group i of
// block j (Params::cluster warps each, threads [32 * G * i, 32 * G * (i +
// 1))) starts on pair j * P + i, then takes the next pair from the
// launch's counter (res[4 * B], zeroed before a launch that has fewer
// groups than pairs), so a group whose pair ends early takes another
// instead of idling until the slowest pair of its block ends. With G > 1
// the group's thread 0 posts the next pair in one of two slots of its
// shared memory, in turns, behind the group's barrier: a slot is written
// again only after a later barrier that every reader of it has passed.
template <int kMetric, int kSpan, bool kRecord, bool kHeur>
__global__ void __launch_bounds__(kGroupMaxThreads)
    fused_loop_group(Params p) {
  extern __shared__ __align__(16) int smem_group[];
  constexpr int kPartials =
      2 * kMaxComps + 1 + (kHeur ? kHeurReductions : 0);
  const int G = p.cluster;
  const int GT = 32 * G;
  const int P = blockDim.x / GT;
  const int slot = threadIdx.x / GT;
  int* off =
      smem_group + slot * group_pair_ints(p.rows, p.W, G, kPartials);
  int* red = off + p.rows * (p.W + 2);
  int* next = red + kPartials * G;
  Group grp;
  grp.t = threadIdx.x - slot * GT;
  grp.lane = threadIdx.x & 31;
  grp.g = grp.t >> 5;
  grp.G = G;
  grp.GT = GT;
  grp.bar = 1 + slot;
  grp.red = red;
  const int groups = gridDim.x * P;
  int b = blockIdx.x * P + slot;
  int turn = 0;
  while (b < p.B) {
    group_pair<kMetric, kSpan, kRecord, kHeur>(p, b, off, grp);
    if (groups >= p.B) break;  // a group a pair: the counter is not zeroed
    if (G == 1) {
      int n = 0;
      if (grp.lane == 0) n = atomicAdd(p.res + 4 * p.B, 1);
      b = groups + __shfl_sync(kFull, n, 0);
      // the last pair's reads of its ring before the next pair's fill
      __syncwarp();
    } else {
      if (grp.t == 0) next[turn] = atomicAdd(p.res + 4 * p.B, 1);
      grp.sync();
      b = groups + next[turn];
      turn ^= 1;
    }
  }
}


// cudaOccupancyMaxActiveClusters of the last cluster launch
// (wfa_fused_loop_active_clusters)
int last_active_clusters = -1;

// An error of a runtime call made for a launch: clear it from the
// runtime's last error, so that it does not come back as the error of the
// next launch, and return it.
int failed(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

// The build the caller chose: the general kernel takes any launch; the
// narrow one a one-shot run on the equality words with a thread a
// diagonal and the ring in shared memory; the group one threads / (32 *
// G) pairs a block, G = Params::cluster warps each, each pair's ring in
// shared memory, one shot or a segment, on the words, table or rows; the
// cluster one a pair a cluster of Params::cluster CTAs, each a slice of
// W / cluster diagonals and its columns of the ring. Shared memory: the
// general and the narrow kernel hold the ring (unless it lives in the
// caller's global ring [B, rows, W]), its bands and the partials of the
// block reductions; the group kernel a ring, its bands and (G > 1) its
// fold partials a pair; the cluster kernel its columns of the ring, the
// bands and rows of C * nwarps partials.
template <int kMetric, int kSpan, bool kRecord, bool kHeur>
int launch(const Params& p, int build, cudaStream_t stream) {
  void (*kernel)(Params);
  size_t smem;
  int grid = p.B;
  const int partials =
      2 * n_comps(kMetric) + 1 + (kHeur ? kHeurReductions : 0);
  if (build == kBuildGroup) {
    const int pairs = p.threads / (32 * p.cluster);
    kernel = fused_loop_group<kMetric, kSpan, kRecord, kHeur>;
    smem = static_cast<size_t>(pairs) *
           group_pair_ints(p.rows, p.W, p.cluster,
                           2 * kMaxComps + 1 +
                               (kHeur ? kHeurReductions : 0)) *
           sizeof(int);
    grid = (p.B + pairs - 1) / pairs;
  } else if (build == kBuildCluster) {
    kernel = fused_loop_cluster<kMetric, kSpan, kRecord, kHeur>;
    grid = p.B * p.cluster;
    smem = 0;  // set below, with the cluster's launch attributes
  } else {
    const size_t ring =
        p.ring_global ? 0 : static_cast<size_t>(p.rows) * p.W;
    smem = (ring + p.rows * 2 + partials * 32) * sizeof(int);
    kernel = build == kBuildNarrow
                 ? fused_loop_narrow<kMetric, kSpan, kRecord, kHeur>
                 : fused_loop<kMetric, kSpan, kRecord, kHeur>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return failed(e);
  }
  if (build == kBuildCluster) {
    smem = (static_cast<size_t>(p.rows) * (p.W / p.cluster) + p.rows * 2 +
            static_cast<size_t>(partials) * p.cluster * (p.threads / 32)) *
           sizeof(int);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return failed(e);
    }
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(grid);
    config.blockDim = dim3(p.threads);
    config.dynamicSmemBytes = smem;
    config.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = p.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
    // a cluster the card cannot schedule is refused here: no fallback
    int clusters = 0;
    cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
    if (e != cudaSuccess) return failed(e);
    last_active_clusters = clusters;
    if (clusters == 0) return failed(cudaErrorInvalidConfiguration);
    e = cudaLaunchKernelEx(&config, kernel, p);
    if (e != cudaSuccess) return failed(e);
    return static_cast<int>(cudaGetLastError());
  }
  if (build == kBuildGroup) {
    // no more blocks than the SMs hold at once (asked of the runtime once
    // a device, block size and shared memory); the pair counter at 0
    // unless every pair has a group of its own
    static std::mutex mu;
    static int cached_device = -1, cached_threads = 0, cached_resident = 0;
    static size_t cached_smem = 0;
    int device = 0, resident = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return failed(e);
    {
      std::lock_guard<std::mutex> lock(mu);
      if (device != cached_device || p.threads != cached_threads ||
          smem != cached_smem) {
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
        if (e == cudaSuccess) {
          e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, kernel, p.threads, smem);
        }
        if (e != cudaSuccess) return failed(e);
        cached_device = device;
        cached_threads = p.threads;
        cached_smem = smem;
        cached_resident = per_sm * sms;
      }
      resident = cached_resident;
    }
    if (resident == 0) return static_cast<int>(cudaErrorInvalidValue);
    grid = min(grid, resident);
    if (static_cast<long long>(grid) * (p.threads / (32 * p.cluster)) <
        p.B) {
      e = cudaMemsetAsync(p.res + 4 * p.B, 0, sizeof(int32_t), stream);
      if (e != cudaSuccess) return failed(e);
    }
  }
  kernel<<<grid, p.threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kMetric, int kSpan>
int launch_span(const Params& p, int build, bool record, bool heur,
                cudaStream_t stream) {
  if (heur) {
    return record ? launch<kMetric, kSpan, true, true>(p, build, stream)
                  : launch<kMetric, kSpan, false, true>(p, build, stream);
  }
  return record ? launch<kMetric, kSpan, true, false>(p, build, stream)
                : launch<kMetric, kSpan, false, false>(p, build, stream);
}

template <int kMetric>
int launch_metric(const Params& p, int build, int span, bool record,
                  bool heur, cudaStream_t stream) {
  if (span == kEndToEnd) {
    return launch_span<kMetric, kEndToEnd>(p, build, record, heur, stream);
  }
  if (span == kEndsFreeWf0) {
    return launch_span<kMetric, kEndsFreeWf0>(p, build, record, heur,
                                              stream);
  }
  // edit and indel carry no match weight: nothing to seed
  if constexpr (kMetric == kEdit || kMetric == kIndel) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return launch_span<kMetric, kSeeded>(p, build, record, heur, stream);
  }
}

}  // namespace

extern "C" {

// Launch the loop for B pairs on `stream`; returns the cudaError_t of the
// launch (0 on success). All pointers are device pointers; `frees` is
// read only on an ends-free span, `choices` written only when record;
// `res` holds 4 * B + 1 ints, the last the group build's pair counter.
// The extension reads exactly one source: `bits` ([NQ, B, W] words),
// `table` ([Ltp, B, W], uint8 when table_u8 else int16), or the token
// rows `pat` [B, Lpp] and `txt` [B, Ltr] compared in place (int8 tokens,
// or int32 class masks when chunk_mode is kChunkClasses; `wildcard` the
// wildcard byte of kChunkWildcard). `ring`, `lohi` and `carry`
// are the state of a segmented run (all nullptr for a one-shot run),
// loaded unless `fresh` and stored at the end; with ring_global the ring
// lives in `ring` ([B, rows, W] ints, which a one-shot run passes as
// scratch) instead of shared memory. `metric` is one of the kMetric codes
// and `span` one of the kSpan codes; x, o1, e1, o2, e2 are the score
// distances of Params (an unused one is 0); `depths` is a host array of
// the ring's rows per component of the metric, M first
// (pywfa_tpu_torch/ops/fused_loop.py::ring_depths); `heur` is a host array
// of the cascade's nine parameters (::heuristic_params), whose first, the
// strategy bits, is 0 for the exact loop; seed_div is -match, read on the
// seeded span. `build` is the kernel the caller chose (kBuild*; `threads`
// is a block's threads, for the group build 32 * G times its pairs, for
// the cluster build a CTA's, at most W / cluster and kClusterThreads;
// `cluster` the units a pair: the group build's G warps, the cluster
// build's CTAs); a launch the build cannot take returns
// cudaErrorInvalidValue and runs nothing, and a cluster the card cannot
// schedule cudaErrorInvalidConfiguration.
int wfa_fused_loop(const void* bits, const void* table, int table_u8,
                   int Ltp, const void* pat, const void* txt, int Lpp,
                   int Ltr, int chunk_mode, int wildcard,
                   const void* plen, const void* tlen,
                   const void* frees, void* choices, void* res, void* ring,
                   void* lohi, void* carry, int fresh, int ring_global,
                   int seg_base, int build, int threads, int cluster,
                   const int* depths, int B, int W, int NQ,
                   int S_cap, int scope, int x, int o1, int e1, int o2, int e2,
                   int max_steps, int metric, int span, int record,
                   const int* heur, int seed_div, void* stream) {
  if (B == 0) return 0;
  if ((span != kEndToEnd && frees == nullptr) ||
      (record && choices == nullptr) || depths == nullptr ||
      heur == nullptr || metric < kAffine || metric > kIndel ||
      span < kEndToEnd || span > kSeeded ||
      (span == kSeeded && seed_div <= 0) ||
      (bits != nullptr) + (table != nullptr) + (pat != nullptr) != 1 ||
      (pat == nullptr) != (txt == nullptr) ||
      (pat != nullptr &&
       (Lpp <= 0 || Ltr <= 0 || chunk_mode < kChunkBytes ||
        chunk_mode > kChunkClasses)) ||
      (carry != nullptr && (ring == nullptr || lohi == nullptr)) ||
      (carry == nullptr && !fresh) || (ring_global && ring == nullptr) ||
      threads < 32 || threads > 1024 || threads % 32 != 0 ||
      build < kBuildGeneral || build > kBuildCluster) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the narrow build: a one-shot run on the equality words, the ring in
  // shared memory, a thread a diagonal; the group build: the ring in
  // shared memory, whole groups of G warps in a block of at most
  // kGroupMaxThreads threads, at most kGroupMaxPairs pairs a block, and
  // with G > 1 a named barrier a pair; the cluster build: the ring in
  // shared memory, W cut into `cluster` slices of whole warps, at most a
  // thread a diagonal
  const bool one_shot = carry == nullptr && bits != nullptr &&
                        !ring_global && fresh && seg_base == 0;
  const int group_pairs = cluster >= 1 ? threads / (32 * cluster) : 0;
  if ((build == kBuildNarrow && !(one_shot && threads == W)) ||
      (build == kBuildGroup &&
       !(!ring_global && cluster >= 1 && threads % (32 * cluster) == 0 &&
         threads <= kGroupMaxThreads && group_pairs <= kGroupMaxPairs &&
         (cluster == 1 || group_pairs <= kNamedBarriers))) ||
      (build == kBuildCluster &&
       !(!ring_global && cluster >= 1 && cluster <= kClusterMax &&
         W % (32 * cluster) == 0 && threads <= W / cluster &&
         threads <= kClusterThreads))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.bits = static_cast<const uint32_t*>(bits);
  p.table = table;
  p.table_u8 = table_u8;
  p.Ltp = Ltp;
  p.pat = pat;
  p.txt = txt;
  p.Lpp = Lpp;
  p.Ltr = Ltr;
  p.chunk_mode = chunk_mode;
  p.wildcard4 = static_cast<uint32_t>(wildcard & 0xFF) * 0x01010101u;
  p.plen = static_cast<const int32_t*>(plen);
  p.tlen = static_cast<const int32_t*>(tlen);
  p.frees = static_cast<const int32_t*>(frees);
  p.choices = static_cast<uint8_t*>(choices);
  p.res = static_cast<int32_t*>(res);
  p.ring = static_cast<int32_t*>(ring);
  p.lohi = static_cast<int32_t*>(lohi);
  p.carry = static_cast<int32_t*>(carry);
  p.fresh = fresh;
  p.ring_global = ring_global;
  p.seg_base = seg_base;
  p.threads = threads;
  p.cluster = (build == kBuildGroup || build == kBuildCluster) ? cluster : 1;
  p.B = B;
  p.W = W;
  p.NQ = NQ;
  p.S_cap = S_cap;
  p.scope = scope;
  p.max_steps = max_steps;
  p.x = x;
  p.o1 = o1;
  p.e1 = e1;
  p.o2 = o2;
  p.e2 = e2;
  p.strategy = heur[0];
  p.min_wf_len = heur[1];
  p.max_dist = heur[2];
  p.steps_between = heur[3];
  p.xdrop = heur[4];
  p.zdrop = heur[5];
  p.band_min_k = heur[6];
  p.band_max_k = heur[7];
  p.swg_match = heur[8];
  p.seed_div = seed_div;
  p.rows = 0;
  for (int c = 0; c < kMaxComps; ++c) {
    p.base[c] = p.rows;
    p.depth[c] = c < n_comps(metric) ? depths[c] : 0;
    p.rows += p.depth[c];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool heuristic = p.strategy != 0;
  switch (metric) {
    case kAffine:
      return launch_metric<kAffine>(p, build, span, record, heuristic, st);
    case kAffine2p:
      return launch_metric<kAffine2p>(p, build, span, record, heuristic, st);
    case kLinear:
      return launch_metric<kLinear>(p, build, span, record, heuristic, st);
    case kEdit:
      return launch_metric<kEdit>(p, build, span, record, heuristic, st);
    default:
      return launch_metric<kIndel>(p, build, span, record, heuristic, st);
  }
}

// cudaOccupancyMaxActiveClusters of the last launch of the cluster build
// (-1 before the first)
int wfa_fused_loop_active_clusters() { return last_active_clusters; }

const char* wfa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
