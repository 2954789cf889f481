// Fused whole-alignment WFA score loop for Hopper (sm_90a): all five
// distance metrics (gap-affine, gap-affine 2-piece, gap-linear, edit,
// indel), end-to-end or ends-free span (with a match bonus too: the
// boundary is then seeded at every score divisible by -match), full-CIGAR
// choice recording or score only, and the heuristic cascade (wf-adaptive,
// wfmash, x-drop, z-drop, banded static and adaptive); one shot from score
// 0, or one segment of a segmented run that loads and stores its state;
// bands of any width; extension by the packed equality words or by the
// run-length table of csrc/lcp_table.cu.
//
// Replaces pywfa_tpu/ops/pallas/fused_loop.py::_kernel (every metric's
// branch, the heuristic cascade and the ends-free match seeding) and both
// of its pallas_calls: the recording one and the score-only one. The plain torch
// version of the same program is
// pywfa_tpu_torch/ops/fused_loop.py::align_batch_fused_loop_ref; both
// produce byte-identical status, final_s, end_k, end_off and choices.
//
// Design: one thread block per pair. A thread owns the diagonals
// w = tid, tid + blockDim, ... (k = kmin + w): one each up to W = 1024,
// several on the wide bands of long reads, where every per-cell phase is
// a strided pass that folds the thread's own diagonals before the warp
// reduction. Nothing per cell lives in a register across a barrier: the
// compute of s + 1 writes each component's cells into its ring row
// untrimmed (no source row shares that slot), and after the trim
// reduction each thread sets the cells it wrote outside the trimmed band
// back to NULL. The wavefront ring and its lo/hi pairs live in dynamic
// shared memory; a ring that does not fit one block (gap-affine past
// W = 3840, the 2-piece metric past W = 1600) lives in a global
// [B, rows, W] array instead, which the L2 holds, and __syncthreads
// orders its reads after its writes within the block. The ring keeps a depth per
// component: M is read as far back as the scope (the largest penalty sum
// plus one), a gap component only at its own extension distance, so it
// keeps gap_extension + 1 rows. Gap-affine at 4/6/2 has 9 + 2 * 3 = 15
// rows (15.4 KB at W = 256); the 2-piece metric at 4/6/2/24/1 has
// 26 + 2 * 3 + 2 * 2 = 36 rows (73.7 KB at W = 512) where five components
// of 26 rows each would not fit one block. Extension reads the packed equality
// words bits[q, b, w] from word off >> 5 upward and stops at the first
// mismatch (__ffs of the inverted word), with reads coalesced across w;
// given the run-length table R[h, b, w] it is one load a cell instead,
// off += R[min(off, Ltp - 1), b, w], with the same bytes out (a run-time
// branch, uniform over the launch: no further instantiation).
// A segment of a segmented run covers scores [seg_base, seg_base + S_cap
// - 1]: it loads the pair's carry, bands and ring from the state unless it
// is the first, records choice level s - seg_base, and stores the state at
// its end; a pair still running then reports ST_OVERFLOW_S in the result
// and stays running in the state; a pair that is done returns at once.
// The end trim takes its first/last in-bounds diagonal per component with
// warp reductions plus a shared-memory pass over the warps' partials.
// Each block leaves its loop as soon as its own pair is done.
//
// Every variant is built as two kernels from one body. The general one
// serves a segment's state, the table and any band. The narrow one is the
// short-read case, chosen at launch from what the launch is given (a
// one-shot run on the equality words, a thread a diagonal, the ring in
// shared memory): every branch on the state, the table and the global
// ring folds away, each strided pass is one step, and the thread's one
// cell of s + 1 waits in registers for the trim, so it takes about half
// the general kernel's registers and more blocks share an SM.
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
// diagonal whose cell reached an end-free boundary: each thread keeps its
// lowest hit, a warp reduction the warp's, and a pass over the warps'
// partials in shared memory picks the block's. kRecord = false is the score-only
// scope: no choice bytes, no choices pointer. kHeur compiles the heuristic
// cascade in, between the termination and the compute of s + 1: the
// strategy bits and parameters are kernel arguments, and since one block
// is one pair every branch of the cascade is uniform over the block, so
// its block reductions (a warp reduction, one partial a warp in shared
// memory, a barrier, a fold) sit behind branches that most steps skip.
// The cascade prunes the band of M at score s in registers, then installs
// it in the ring and cuts every gap component's row of score s to it; the
// bands of those rows are kept in registers, so the install reads no
// shared lo/hi pair that another thread writes.
//
// What bounds it: the per-step __syncthreads latency (two barriers per
// score step), not bytes; a batch of few long pairs also leaves most SMs
// idle, one block a pair. The choices record
// is about 100 MB for a 4096-pair batch at W = 256, tens of microseconds
// at the card's bandwidth. Making it fast (several pairs per block, a
// warp per pair, fewer barriers) is later work.
//
// A band that outgrows W, at WF0 or later, reports ST_OVERFLOW_W instead
// of being clamped silently, as the XLA engine of the reference package
// does.

#include <cuda_runtime.h>
#include <stdint.h>

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
  const int32_t* plen;   // [B]
  const int32_t* tlen;   // [B]
  const int32_t* frees;  // [B, 4]: pattern begin/end, text begin/end free
  uint8_t* choices;      // [S_cap, B, W], zero on entry; unused unless kRecord
  int32_t* res;          // [4, B]: status, final_s, end_k, end_off
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
  // threads of a block; each owns diagonals tid, tid + T, ...
  int threads;
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
__device__ __forceinline__ Wf read_wf(const int* off, const int* lohi,
                                      const Params& p, int comp, int slot1,
                                      int dist, int s1) {
  Wf f;
  const int W = p.W;
  if (s1 - dist < 0) {
    f.row = nullptr;
    f.lo = 1;
    f.hi = -1;
  } else {
    int j = slot1 - dist;
    if (j < 0) j += p.depth[comp];
    const int i = p.base[comp] + j;
    f.row = off + i * W;
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

// Block reductions: every thread posts its value, already folded over the
// diagonals it owns (each warp's lane 0 writes the warp's partial into a
// row of 32 ints that the reduction owns), the caller places one
// __syncthreads, and every warp folds the row: lane i takes warp i's
// partial and one more warp reduction gives every thread the result (a
// block has at most 32 warps; the callers' branches are uniform over the
// block, so every lane is there).
__device__ __forceinline__ void post_min(int* row, int v, int lane,
                                         int warp) {
  v = __reduce_min_sync(0xFFFFFFFFu, v);
  if (lane == 0) row[warp] = v;
}

__device__ __forceinline__ void post_max(int* row, int v, int lane,
                                         int warp) {
  v = __reduce_max_sync(0xFFFFFFFFu, v);
  if (lane == 0) row[warp] = v;
}

__device__ __forceinline__ int fold_min(const int* row, int nwarps,
                                        int lane) {
  return __reduce_min_sync(0xFFFFFFFFu, lane < nwarps ? row[lane] : kBig);
}

__device__ __forceinline__ int fold_max(const int* row, int nwarps,
                                        int lane) {
  return __reduce_max_sync(0xFFFFFFFFu, lane < nwarps ? row[lane] : -kBig);
}

// wfmash's length-normalised distance, float32 in a fixed order: divide,
// multiply, truncate (saturating, NaN to 0); nothing contracts
__device__ __forceinline__ int mash_dist(int left, int len, float mfactor) {
  return __float2int_rz(__fmul_rn(
      __fdiv_rn(__int2float_rn(left), __int2float_rn(len)), mfactor));
}

// The loop of one pair. kNarrow is the one-shot run of a band of at most
// 1024 diagonals on the equality words: one diagonal a thread, the ring in
// shared memory, no state and no table, so every branch on those folds
// away and each strided pass below is a single step (see launch()).
template <int kMetric, int kSpan, bool kRecord, bool kHeur, bool kNarrow>
__device__ __forceinline__ void loop_body(const Params& p) {
  constexpr int kComps = n_comps(kMetric);
  constexpr bool kEditLike = kMetric == kEdit || kMetric == kIndel;
  constexpr bool kEndsFree = kSpan != kEndToEnd;
  constexpr bool kSeeding = kSpan == kSeeded;
  extern __shared__ int smem[];
  const int W = p.W;
  const int T = blockDim.x;
  const int scope = p.scope;
  const int b = blockIdx.x;
  int* lohi = smem;                       // [rows][2]
  int* red = lohi + p.rows * 2;           // [2 * kComps][32] trim partials
  int* term = red + 2 * kComps * 32;      // [32] ends-free hit partials
  int* hred = term + 32;  // [kHeurReductions][32] cascade partials (kHeur)
  // the ring [rows][W]: shared memory, or this pair's slice of the global
  // ring when the rows do not fit one block's shared memory
  const bool fresh = kNarrow || p.fresh;
  const bool ring_global = !kNarrow && p.ring_global;
  const int seg_base = kNarrow ? 0 : p.seg_base;
  int* ring_g = (kNarrow || p.ring == nullptr)
                    ? nullptr
                    : p.ring + static_cast<size_t>(b) * p.rows * W;
  int* off = ring_global ? ring_g
                         : hred + (kHeur ? kHeurReductions * 32 : 0);

  const int tid = threadIdx.x;
  if (kNarrow) __builtin_assume(tid < W);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = T >> 5;
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
  uint8_t* choices = kRecord ? p.choices + bW : nullptr;
  const int NQ32 = p.NQ * 32;
  const int seg_end = seg_base + p.S_cap - 1;
  int32_t* carry = (kNarrow || p.carry == nullptr)
                       ? nullptr
                       : p.carry + static_cast<size_t>(b) * kCarry;

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
    for (int i = tid; i < p.rows * W; i += T) {
      const int k = kmin + i;
      off[i] = (i < W && k >= wf0_lo && k <= wf0_hi) ? max(k, 0) : kNull;
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
      if (tid == 0) {
        p.res[b] = status;
        p.res[p.B + b] = final_s;
        p.res[2 * p.B + b] = end_k;
        p.res[3 * p.B + b] = end_off;
      }
      return;
    }
    if (!ring_global) {
      for (int i = tid; i < p.rows * W; i += T) off[i] = ring_g[i];
    }
    const int32_t* lg = p.lohi + static_cast<size_t>(b) * p.rows * 2;
    for (int i = tid; i < p.rows * 2; i += T) lohi[i] = lg[i];
  }
  __syncthreads();

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
    int* m_row = off + slot[M] * W;  // M owns rows [0, scope)
    const bool m_null = m_lo > m_hi;
    // feasibility probe: a run of null steps longer than the scope
    if (m_null && nnull > scope) {
      status = ST_END_UNREACHABLE;
      final_s = s;
      done = true;
      break;
    }

    // --- extension: first mismatch at or after the cell's offset, by the
    // packed equality words or by the run-length table ---
    int first_hit = W;
    if (!m_null) {
      for (int w = tid; w < W; w = kNarrow ? W : w + T) {
        const int k = kmin + w;
        int m_off = m_row[w];
        const bool inband = k >= m_lo && k <= m_hi;
        if (inband && m_off >= 0 && m_off <= tlen) {
          if (table8 != nullptr) {
            const size_t at_h =
                static_cast<size_t>(min(m_off, p.Ltp - 1)) * BW + w;
            m_off += p.table_u8
                         ? static_cast<int>(table8[at_h])
                         : static_cast<int>(reinterpret_cast<const int16_t*>(
                               table8)[at_h]);
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
          m_row[w] = m_off;
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
    if (kEndsFree) post_min(term, first_hit, lane, warp);
    __syncthreads();

    // --- termination ---
    if (kEndsFree) {
      const int first = fold_min(term, nwarps, lane);
      if (first < W) {
        status = ST_END_REACHED;
        final_s = s;
        end_k = first + kmin;
        end_off = m_row[first];
        done = true;
        break;
      }
    } else {
      // the end cell k = tlen - plen reached offset tlen
      const int ak = tlen - plen;
      const int aw = ak - kmin;
      const int cell = (aw >= 0 && aw < W) ? m_row[aw] : 0;
      if (!m_null && m_lo <= ak && ak <= m_hi && cell >= tlen) {
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
          for (int w = tid; w < W; w = kNarrow ? W : w + T) {
            const int k = kmin + w;
            const bool hband = k >= cur_lo && k <= cur_hi;
            mn = min(mn, hband ? dist_of(k, m_row[w]) : max(plen, tlen));
          }
          post_min(hred, mn, lane, warp);
          __syncthreads();
          const int mind = fold_min(hred, nwarps, lane);
          const int ak = tlen - plen;
          const int top_limit = min(ak, cur_hi);
          // the highest kept diagonal above ak is the highest above
          // max(ak, new lo) too, if any is
          int f = W, l = -1;
          for (int w = tid; w < W; w = kNarrow ? W : w + T) {
            const int k = kmin + w;
            const bool keep = k >= cur_lo && k <= cur_hi &&
                              dist_of(k, m_row[w]) - mind <= p.max_dist;
            if (keep && k < top_limit) f = min(f, w);
            if (keep && k > ak) l = max(l, w);
          }
          post_min(hred + 32, f, lane, warp);
          post_max(hred + 64, l, lane, warp);
          __syncthreads();
          const int first = fold_min(hred + 32, nwarps, lane);
          const int last = fold_max(hred + 64, nwarps, lane);
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
          for (int w = tid; w < W; w = kNarrow ? W : w + T) {
            mx = max(mx, sw_of(kmin + w, m_row[w]));
          }
          post_max(hred + 96, mx, lane, warp);
          __syncthreads();
          const int cmax = fold_max(hred + 96, nwarps, lane);
          const bool xd = (st & kXdrop) != 0;
          int ci = W, fx = W, lx = -1;
          for (int w = tid; w < W; w = kNarrow ? W : w + T) {
            const int sw = sw_of(kmin + w, m_row[w]);
            if (sw == cmax) ci = min(ci, w);
            if (xd && sw > -kBig && hm_sw - sw < p.xdrop) {
              fx = min(fx, w);
              lx = max(lx, w);
            }
          }
          post_min(hred + 128, ci, lane, warp);
          if (xd) {
            post_min(hred + 160, fx, lane, warp);
            post_max(hred + 192, lx, lane, warp);
          }
          __syncthreads();
          const int cidx = fold_min(hred + 128, nwarps, lane);
          const bool improved = !hm_valid || cmax > hm_sw;
          if (xd) {
            if (hm_valid) {
              const int firstx = fold_min(hred + 160, nwarps, lane);
              const int lastx = fold_max(hred + 192, nwarps, lane);
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
              hm_off = m_row[min(cidx, W - 1)];
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
          // install M's pruned band, cut every gap component's row of
          // score s to it (a null row stays null), and let the compute
          // of s + 1 see both
#pragma unroll
          for (int c = 1; c < kComps; ++c) {
            g_lo[c] = max(g_lo[c], cur_lo);
            g_hi[c] = min(g_hi[c], cur_hi);
          }
          for (int w = tid; w < W; w = kNarrow ? W : w + T) {
            const int k = kmin + w;
            if (k < cur_lo || k > cur_hi) m_row[w] = kNull;
#pragma unroll
            for (int c = 1; c < kComps; ++c) {
              if (k < g_lo[c] || k > g_hi[c]) {
                off[(p.base[c] + slot[c]) * W + w] = kNull;
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
          __syncthreads();
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
      mm = read_wf(off, lohi, p, M, slot1[M], 1, s1);
      lo_n = mm.lo - 1;
      hi_n = mm.hi + 1;
      all_null = mm.null_;
    } else if constexpr (kMetric == kLinear) {
      mm = read_wf(off, lohi, p, M, slot1[M], p.x, s1);
      op = read_wf(off, lohi, p, M, slot1[M], p.o1, s1);
      lo_n = min(lim_lo(mm, 0), lim_lo(op, 1));
      hi_n = max(lim_hi(mm, 0), lim_hi(op, 1));
      all_null = mm.null_ && op.null_;
    } else {
      mm = read_wf(off, lohi, p, M, slot1[M], p.x, s1);
      op = read_wf(off, lohi, p, M, slot1[M], p.o1, s1);
      i1 = read_wf(off, lohi, p, I1, slot1[I1], p.e1, s1);
      d1 = read_wf(off, lohi, p, D1, slot1[D1], p.e1, s1);
      lo_n = min(min(lim_lo(mm, 0), lim_lo(op, 1)),
                 min(lim_lo(i1, 1), lim_lo(d1, 1)));
      hi_n = max(max(lim_hi(mm, 0), lim_hi(op, 1)),
                 max(lim_hi(i1, 1), lim_hi(d1, 1)));
      all_null = mm.null_ && op.null_ && i1.null_ && d1.null_;
      prod[I1] = !(op.null_ && i1.null_);
      prod[D1] = !(op.null_ && d1.null_);
      if constexpr (kMetric == kAffine2p) {
        // I2 and D2 are the last two of the five components
        op2 = read_wf(off, lohi, p, M, slot1[M], p.o2, s1);
        i2 = read_wf(off, lohi, p, I2, slot1[kComps - 2], p.e2, s1);
        d2 = read_wf(off, lohi, p, D2, slot1[kComps - 1], p.e2, s1);
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
    for (int w = tid; w < W; w = kNarrow ? W : w + T) {
      const int k = kmin + w;
      int arr[kComps];
      int choice, mval;
      if constexpr (kEditLike) {
        // every candidate comes from the wavefront of s
        int pm =
            max(pack(at(mm, w + 1, W), 3), pack(at(mm, w - 1, W) + 1, 1));
        if constexpr (kMetric == kEdit) {
          pm = max(pack(at(mm, w, W) + 1, 5), pm);
        }
        // an all-invalid cell stays negative; the bounds check nulls it
        mval = pm >> 3;
        choice = one_comp_source(pm);
      } else if constexpr (kMetric == kLinear) {
        const int pm = max(pack(at(mm, w, W) + 1, 5),
                           max(pack(at(op, w + 1, W), 3),
                               pack(at(op, w - 1, W) + 1, 1)));
        mval = pm < 0 ? kNull : (pm >> 3);
        choice = one_comp_source(pm);
      } else {
        int i1_ext, d1_ext;
        const int ins1 =
            gap_cell(at(op, w - 1, W), at(i1, w - 1, W), 1, &i1_ext);
        const int del1 =
            gap_cell(at(op, w + 1, W), at(d1, w + 1, W), 0, &d1_ext);
        const int mis = at(mm, w, W) + 1;
        arr[I1] = ins1;
        arr[D1] = del1;
        // M by the packed (value << 3) | prio max
        int pm, raw;
        if constexpr (kMetric == kAffine2p) {
          int i2_ext, d2_ext;
          const int ins2 =
              gap_cell(at(op2, w - 1, W), at(i2, w - 1, W), 1, &i2_ext);
          const int del2 =
              gap_cell(at(op2, w + 1, W), at(d2, w + 1, W), 0, &d2_ext);
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
          off[(p.base[c] + slot1[c]) * W + w] = arr[c];
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
      post_min(red + c * 32, wmin[c], lane, warp);
      post_max(red + (kComps + c) * 32, wmax[c], lane, warp);
    }
    __syncthreads();

    // end trim per component: the cells of the row outside the trimmed
    // band go back to NULL (each thread trims the cells it wrote); the
    // narrow kernel writes its cell now, trimmed
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      const int first = fold_min(red + c * 32, nwarps, lane);
      const int last = fold_max(red + (kComps + c) * 32, nwarps, lane);
      const bool keep = prod[c] && first < W;
      int tlo = keep ? first + kmin : 1;
      int thi = keep ? last + kmin : -1;
      if (kSeeding && c == M && seeded_null) {
        tlo = lo_n;
        thi = hi_n;
      }
      const int row = p.base[c] + slot1[c];
      if (kNarrow) {
        const int k = kmin + tid;
        off[row * W + tid] = (k >= tlo && k <= thi) ? held[c] : kNull;
      } else if (tlo > lo_n || thi < hi_n || !keep) {
        for (int w = tid; w < W; w = kNarrow ? W : w + T) {
          const int k = kmin + w;
          if (k < tlo || k > thi) off[row * W + w] = kNull;
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
      choices[static_cast<size_t>(s1) * BW + tid] =
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
  if (carry != nullptr) {
    // the state of a later segment: a pair still running stays running
    // there, whatever its result says below
    __syncthreads();
    if (!ring_global) {
      for (int i = tid; i < p.rows * W; i += T) ring_g[i] = off[i];
    }
    int32_t* lg = p.lohi + static_cast<size_t>(b) * p.rows * 2;
    for (int i = tid; i < p.rows * 2; i += T) lg[i] = lohi[i];
    if (tid == 0) {
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
  if (tid == 0) {
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
  loop_body<kMetric, kSpan, kRecord, kHeur, false>(p);
}

// The narrow kernel of short reads (loop_body's kNarrow): fewer registers,
// so more blocks share an SM in a loop that waits on its barriers.
template <int kMetric, int kSpan, bool kRecord, bool kHeur>
__global__ void fused_loop_narrow(Params p) {
  loop_body<kMetric, kSpan, kRecord, kHeur, true>(p);
}

// The ring's rows in shared memory when they fit one block; else the
// caller's global ring [B, rows, W], and only the bands and the partials
// in shared memory. A one-shot run on the equality words with a thread a
// diagonal and the ring in shared memory launches the narrow kernel, any
// other the general one: the choice reads only what the launch is given.
template <int kMetric, int kSpan, bool kRecord, bool kHeur>
int launch(const Params& p, cudaStream_t stream) {
  const size_t ring = p.ring_global ? 0 : static_cast<size_t>(p.rows) * p.W;
  const size_t smem =
      (ring + p.rows * 2 +
       (2 * n_comps(kMetric) + 1 + (kHeur ? kHeurReductions : 0)) * 32) *
      sizeof(int);
  const bool narrow = p.threads == p.W && p.carry == nullptr &&
                      p.table == nullptr && !p.ring_global;
  void (*kernel)(Params) =
      narrow ? fused_loop_narrow<kMetric, kSpan, kRecord, kHeur>
             : fused_loop<kMetric, kSpan, kRecord, kHeur>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<p.B, p.threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int kMetric, int kSpan>
int launch_span(const Params& p, bool record, bool heur,
                cudaStream_t stream) {
  if (heur) {
    return record ? launch<kMetric, kSpan, true, true>(p, stream)
                  : launch<kMetric, kSpan, false, true>(p, stream);
  }
  return record ? launch<kMetric, kSpan, true, false>(p, stream)
                : launch<kMetric, kSpan, false, false>(p, stream);
}

template <int kMetric>
int launch_metric(const Params& p, int span, bool record, bool heur,
                  cudaStream_t stream) {
  if (span == kEndToEnd) {
    return launch_span<kMetric, kEndToEnd>(p, record, heur, stream);
  }
  if (span == kEndsFreeWf0) {
    return launch_span<kMetric, kEndsFreeWf0>(p, record, heur, stream);
  }
  // edit and indel carry no match weight: nothing to seed
  if constexpr (kMetric == kEdit || kMetric == kIndel) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return launch_span<kMetric, kSeeded>(p, record, heur, stream);
  }
}

}  // namespace

extern "C" {

// Launch the loop for B pairs on `stream`; returns the cudaError_t of the
// launch (0 on success). All pointers are device pointers; `frees` is
// read only on an ends-free span, `choices` written only when record.
// The extension reads `table` ([Ltp, B, W], uint8 when table_u8 else
// int16) when it is not nullptr, else `bits`. `ring`, `lohi` and `carry`
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
// seeded span.
int wfa_fused_loop(const void* bits, const void* table, int table_u8,
                   int Ltp, const void* plen, const void* tlen,
                   const void* frees, void* choices, void* res, void* ring,
                   void* lohi, void* carry, int fresh, int ring_global,
                   int seg_base, int threads, const int* depths, int B,
                   int W, int NQ, int S_cap, int scope, int x, int o1,
                   int e1, int o2, int e2, int max_steps, int metric,
                   int span, int record, const int* heur, int seed_div,
                   void* stream) {
  if (B == 0) return 0;
  if ((span != kEndToEnd && frees == nullptr) ||
      (record && choices == nullptr) || depths == nullptr ||
      heur == nullptr || metric < kAffine || metric > kIndel ||
      span < kEndToEnd || span > kSeeded ||
      (span == kSeeded && seed_div <= 0) ||
      (bits == nullptr && table == nullptr) ||
      (carry != nullptr && (ring == nullptr || lohi == nullptr)) ||
      (carry == nullptr && !fresh) || (ring_global && ring == nullptr) ||
      threads < 32 || threads > 1024 || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.bits = static_cast<const uint32_t*>(bits);
  p.table = table;
  p.table_u8 = table_u8;
  p.Ltp = Ltp;
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
      return launch_metric<kAffine>(p, span, record, heuristic, st);
    case kAffine2p:
      return launch_metric<kAffine2p>(p, span, record, heuristic, st);
    case kLinear:
      return launch_metric<kLinear>(p, span, record, heuristic, st);
    case kEdit:
      return launch_metric<kEdit>(p, span, record, heuristic, st);
    default:
      return launch_metric<kIndel>(p, span, record, heuristic, st);
  }
}

const char* wfa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
