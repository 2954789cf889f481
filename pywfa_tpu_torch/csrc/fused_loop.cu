// Fused whole-alignment WFA score loop for Hopper (sm_90a): all five
// distance metrics (gap-affine, gap-affine 2-piece, gap-linear, edit,
// indel), end-to-end or ends-free span (with a match bonus too: the
// boundary is then seeded at every score divisible by -match), full-CIGAR
// choice recording or score only, and the heuristic cascade (wf-adaptive,
// wfmash, x-drop, z-drop, banded static and adaptive).
//
// Replaces pywfa_tpu/ops/pallas/fused_loop.py::_kernel (every metric's
// branch, the heuristic cascade and the ends-free match seeding) and both
// of its pallas_calls: the recording one and the score-only one. The plain torch
// version of the same program is
// pywfa_tpu_torch/ops/fused_loop.py::align_batch_fused_loop_ref; both
// produce byte-identical status, final_s, end_k, end_off and choices.
//
// Design: one thread block per pair, one thread per diagonal
// (blockDim = W, thread w owns k = kmin + w). The wavefront ring and its
// lo/hi pairs live in dynamic shared memory. The ring keeps a depth per
// component: M is read as far back as the scope (the largest penalty sum
// plus one), a gap component only at its own extension distance, so it
// keeps gap_extension + 1 rows. Gap-affine at 4/6/2 has 9 + 2 * 3 = 15
// rows (15.4 KB at W = 256); the 2-piece metric at 4/6/2/24/1 has
// 26 + 2 * 3 + 2 * 2 = 36 rows (73.7 KB at W = 512) where five components
// of 26 rows each would not fit one block. Extension reads the packed equality
// words bits[q, b, w] from word off >> 5 upward and stops at the first
// mismatch (__ffs of the inverted word), with reads coalesced across w.
// The end trim takes its first/last in-bounds diagonal per component with
// warp reductions plus a shared-memory pass over the warps' partials.
// Each block leaves its loop as soon as its own pair is done.
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
// diagonal whose cell reached an end-free boundary: each warp ballots its
// hits, __ffs picks the warp's lowest, and a pass over the warps' partials
// in shared memory picks the block's. kRecord = false is the score-only
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
// score step, a few hundred steps at most), not bytes. The choices record
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

struct Params {
  const uint32_t* bits;  // [NQ, B, W] packed equality words
  const int32_t* plen;   // [B]
  const int32_t* tlen;   // [B]
  const int32_t* frees;  // [B, 4]: pattern begin/end, text begin/end free
  uint8_t* choices;      // [S_cap, B, W], zero on entry; unused unless kRecord
  int32_t* res;          // [4, B]: status, final_s, end_k, end_off
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

// Block reductions of the cascade: every thread posts its value (each
// warp's lane 0 writes the warp's partial into a row of 32 ints that the
// reduction owns), the caller places one __syncthreads, and every thread
// folds the row.
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

__device__ __forceinline__ int fold_min(const int* row, int nwarps) {
  int r = row[0];
  for (int i = 1; i < nwarps; ++i) r = min(r, row[i]);
  return r;
}

__device__ __forceinline__ int fold_max(const int* row, int nwarps) {
  int r = row[0];
  for (int i = 1; i < nwarps; ++i) r = max(r, row[i]);
  return r;
}

// wfmash's length-normalised distance, float32 in a fixed order: divide,
// multiply, truncate (saturating, NaN to 0); nothing contracts
__device__ __forceinline__ int mash_dist(int left, int len, float mfactor) {
  return __float2int_rz(__fmul_rn(
      __fdiv_rn(__int2float_rn(left), __int2float_rn(len)), mfactor));
}

template <int kMetric, int kSpan, bool kRecord, bool kHeur>
__global__ void fused_loop(Params p) {
  constexpr int kComps = n_comps(kMetric);
  constexpr bool kEditLike = kMetric == kEdit || kMetric == kIndel;
  constexpr bool kEndsFree = kSpan != kEndToEnd;
  constexpr bool kSeeding = kSpan == kSeeded;
  extern __shared__ int smem[];
  const int W = p.W;
  const int scope = p.scope;
  int* off = smem;                        // [rows][W]
  int* lohi = off + p.rows * W;           // [rows][2]
  int* red = lohi + p.rows * 2;           // [2 * kComps][32] trim partials
  int* term = red + 2 * kComps * 32;      // [32] ends-free hit partials
  int* hred = term + 32;  // [kHeurReductions][32] cascade partials (kHeur)

  const int w = threadIdx.x;
  const int b = blockIdx.x;
  const int lane = w & 31;
  const int warp = w >> 5;
  const int nwarps = W >> 5;
  const int kmin = -(W / 2);
  const int k = kmin + w;
  const int plen = p.plen[b];
  const int tlen = p.tlen[b];
  const size_t BW = static_cast<size_t>(p.B) * W;
  const uint32_t* bits = p.bits + static_cast<size_t>(b) * W + w;
  uint8_t* choices =
      kRecord ? p.choices + static_cast<size_t>(b) * W + w : nullptr;
  const int NQ32 = p.NQ * 32;

  // WF0: M at score 0 holds the begin-free seeds, diagonals
  // [-pattern_begin_free, text_begin_free] at offset max(k, 0); without
  // the ends-free span only k = 0, offset 0
  // with a match bonus (kSeeding) WF0 is k = 0 alone and the begin frees
  // seed later scores
  int wf0_lo = 0, wf0_hi = 0, pbf = 0, pef = 0, tbf = 0, tef = 0;
  if (kEndsFree) {
    const int32_t* fr = p.frees + 4 * static_cast<size_t>(b);
    pbf = fr[0];
    pef = fr[1];
    tbf = fr[2];
    tef = fr[3];
    if (!kSeeding) {
      wf0_lo = -pbf;
      wf0_hi = tbf;
    }
  }
  for (int i = 0; i < p.rows; ++i) off[i * W + w] = kNull;
  off[w] = (k >= wf0_lo && k <= wf0_hi) ? max(k, 0) : kNull;  // M, score 0
  for (int i = w; i < p.rows; i += W) {
    lohi[2 * i] = (i == 0) ? wf0_lo : 1;
    lohi[2 * i + 1] = (i == 0) ? wf0_hi : -1;
  }
  __syncthreads();

  // block-uniform state: every thread computes the same values
  int s = 0, status = 0, final_s = 0, end_k = 0, end_off = kNull;
  int nnull = 0;
  // seeds past the band: the pair escalates before its first step
  bool done = kSpan == kEndsFreeWf0 &&
              (wf0_lo < kmin + 2 || wf0_hi > kmin + W - 3);
  if (done) status = ST_OVERFLOW_W;
  int m_lo = wf0_lo, m_hi = wf0_hi;  // band of M at score s
  // bands of the gap components' rows of score s (read by the cascade)
  int g_lo[kComps], g_hi[kComps];
#pragma unroll
  for (int c = 0; c < kComps; ++c) {
    g_lo[c] = 1;
    g_hi[c] = -1;
  }
  // the cascade's carry: steps to the next cutoff, and the historic
  // maximum of the drop heuristics (its score, diagonal, offset)
  int h_wait = p.steps_between;
  int hm_sw = 0, hm_k = 0, hm_off = kNull;
  bool hm_valid = false;
  // each component's ring slot of score s (s % depth, without the modulo)
  int slot[kComps];
#pragma unroll
  for (int c = 0; c < kComps; ++c) slot[c] = 0;

  while (!done && s < p.S_cap - 1) {
    int* m_row = off + slot[M] * W;  // M owns rows [0, scope)
    const bool m_null = m_lo > m_hi;
    // feasibility probe: a run of null steps longer than the scope
    if (m_null && nnull > scope) {
      status = ST_END_UNREACHABLE;
      final_s = s;
      done = true;
      break;
    }

    // --- extension: first mismatch at or after the cell's offset ---
    int m_off = m_row[w];
    if (!m_null && k >= m_lo && k <= m_hi && m_off >= 0 && m_off <= tlen) {
      const int idx = min(m_off, NQ32 - 1);
      int q = idx >> 5;
      uint32_t mq = ~__ldg(bits + q * BW) & (0xFFFFFFFFu << (idx & 31));
      while (mq == 0 && ++q < p.NQ) mq = ~__ldg(bits + q * BW);
      // the sentinel padding guarantees a mismatch before the row end
      const int fm = (mq != 0) ? q * 32 + __ffs(static_cast<int>(mq)) - 1
                               : NQ32;
      m_off += fm - idx;
      m_row[w] = m_off;
    }
    if (kEndsFree) {
      // a cell on an end-free boundary: the text consumed with at most
      // pattern_end_free bases left, or the pattern with at most
      // text_end_free left; each warp posts its lowest such diagonal
      const int v = m_off - k;
      const bool cellv = !m_null && k >= m_lo && k <= m_hi &&
                         m_off > kNullThreshold;
      const bool hit = cellv && ((m_off >= tlen && plen - v <= pef) ||
                                 (v >= plen && tlen - m_off <= tef));
      const unsigned ballot = __ballot_sync(0xFFFFFFFFu, hit);
      if (lane == 0) term[warp] = ballot ? warp * 32 + __ffs(ballot) - 1 : W;
    }
    __syncthreads();

    // --- termination ---
    if (kEndsFree) {
      // the lowest diagonal that hit wins
      int first = W;
      for (int i = 0; i < nwarps; ++i) first = min(first, term[i]);
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
    // reads it. Every condition below is uniform over the block. ---
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
          const bool hband = k >= cur_lo && k <= cur_hi;
          int dist = -kNull;
          if (m_off >= 0) {
            const int v = m_off - k;
            if (st & kWfMash) {
              const float mfactor =
                  __fdiv_rn(__int2float_rn(plen + tlen), 2.0f);
              dist = max(mash_dist(plen - v, plen, mfactor),
                         mash_dist(tlen - m_off, tlen, mfactor));
            } else {
              dist = max(plen - v, tlen - m_off);
            }
          }
          post_min(hred, hband ? dist : max(plen, tlen), lane, warp);
          __syncthreads();
          const int mind = fold_min(hred, nwarps);
          const bool keep = hband && dist - mind <= p.max_dist;
          const int ak = tlen - plen;
          const int top_limit = min(ak, cur_hi);
          // the highest kept diagonal above ak is the highest above
          // max(ak, new lo) too, if any is
          post_min(hred + 32, keep && k < top_limit ? w : W, lane, warp);
          post_max(hred + 64, keep && k > ak ? w : -1, lane, warp);
          __syncthreads();
          const int first = fold_min(hred + 32, nwarps);
          const int last = fold_max(hred + 64, nwarps);
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
          const bool validc = k >= cur_lo && k <= cur_hi && m_off >= 0;
          // (C division truncates, as the reference's does)
          const int sw =
              validc ? (p.swg_match * (m_off - k + m_off) - s) / 2 : -kBig;
          post_max(hred + 96, sw, lane, warp);
          __syncthreads();
          const int cmax = fold_max(hred + 96, nwarps);
          post_min(hred + 128, sw == cmax ? w : W, lane, warp);
          const bool xd = (st & kXdrop) != 0;
          if (xd) {
            const bool keepx = validc && hm_sw - sw < p.xdrop;
            post_min(hred + 160, keepx ? w : W, lane, warp);
            post_max(hred + 192, keepx ? w : -1, lane, warp);
          }
          __syncthreads();
          const int cidx = fold_min(hred + 128, nwarps);
          const bool improved = !hm_valid || cmax > hm_sw;
          if (xd) {
            if (hm_valid) {
              const int firstx = fold_min(hred + 160, nwarps);
              const int lastx = fold_max(hred + 192, nwarps);
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
              hm_off = m_row[cidx];
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
          if (k < cur_lo || k > cur_hi) m_row[w] = kNull;
          if (w == 0) {
            lohi[2 * slot[M]] = cur_lo;
            lohi[2 * slot[M] + 1] = cur_hi;
          }
#pragma unroll
          for (int c = 1; c < kComps; ++c) {
            const int row = p.base[c] + slot[c];
            g_lo[c] = max(g_lo[c], cur_lo);
            g_hi[c] = min(g_hi[c], cur_hi);
            if (k < g_lo[c] || k > g_hi[c]) off[row * W + w] = kNull;
            if (w == 0) {
              lohi[2 * row] = g_lo[c];
              lohi[2 * row + 1] = g_hi[c];
            }
          }
          __syncthreads();
        }
      }
    }

    // --- compute s + 1 ---
    const int s1 = s + 1;
    int slot1[kComps];  // the slots of score s + 1
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      slot1[c] = slot[c] + 1 == p.depth[c] ? 0 : slot[c] + 1;
    }
    // per component: the cell's value and whether the component is
    // produced at all (M on every non-null step, a gap component only
    // when one of its sources exists)
    int arr[kComps];
    bool prod[kComps];
    int lo_n, hi_n, choice, mval;
    bool all_null;
    if constexpr (kEditLike) {
      // every candidate comes from the wavefront of s
      const Wf pw = read_wf(off, lohi, p, M, slot1[M], 1, s1);
      lo_n = pw.lo - 1;
      hi_n = pw.hi + 1;
      all_null = pw.null_;
      int pm = max(pack(at(pw, w + 1, W), 3), pack(at(pw, w - 1, W) + 1, 1));
      if constexpr (kMetric == kEdit) pm = max(pack(at(pw, w, W) + 1, 5), pm);
      // an all-invalid cell stays negative; the bounds check nulls it
      mval = pm >> 3;
      choice = one_comp_source(pm);
    } else if constexpr (kMetric == kLinear) {
      const Wf mm = read_wf(off, lohi, p, M, slot1[M], p.x, s1);
      const Wf op = read_wf(off, lohi, p, M, slot1[M], p.o1, s1);
      lo_n = min(lim_lo(mm, 0), lim_lo(op, 1));
      hi_n = max(lim_hi(mm, 0), lim_hi(op, 1));
      all_null = mm.null_ && op.null_;
      const int pm = max(pack(at(mm, w, W) + 1, 5),
                         max(pack(at(op, w + 1, W), 3),
                             pack(at(op, w - 1, W) + 1, 1)));
      mval = pm < 0 ? kNull : (pm >> 3);
      choice = one_comp_source(pm);
    } else {
      const Wf mm = read_wf(off, lohi, p, M, slot1[M], p.x, s1);
      const Wf op = read_wf(off, lohi, p, M, slot1[M], p.o1, s1);
      const Wf i1 = read_wf(off, lohi, p, I1, slot1[I1], p.e1, s1);
      const Wf d1 = read_wf(off, lohi, p, D1, slot1[D1], p.e1, s1);
      lo_n = min(min(lim_lo(mm, 0), lim_lo(op, 1)),
                 min(lim_lo(i1, 1), lim_lo(d1, 1)));
      hi_n = max(max(lim_hi(mm, 0), lim_hi(op, 1)),
                 max(lim_hi(i1, 1), lim_hi(d1, 1)));
      all_null = mm.null_ && op.null_ && i1.null_ && d1.null_;
      int i1_ext, d1_ext;
      const int ins1 =
          gap_cell(at(op, w - 1, W), at(i1, w - 1, W), 1, &i1_ext);
      const int del1 =
          gap_cell(at(op, w + 1, W), at(d1, w + 1, W), 0, &d1_ext);
      const int mis = at(mm, w, W) + 1;
      arr[I1] = ins1;
      arr[D1] = del1;
      prod[I1] = !(op.null_ && i1.null_);
      prod[D1] = !(op.null_ && d1.null_);
      // M by the packed (value << 3) | prio max
      int pm, raw;
      if constexpr (kMetric == kAffine2p) {
        const Wf op2 = read_wf(off, lohi, p, M, slot1[M], p.o2, s1);
        const Wf i2 =
            read_wf(off, lohi, p, I2, slot1[kComps - 2], p.e2, s1);
        const Wf d2 =
            read_wf(off, lohi, p, D2, slot1[kComps - 1], p.e2, s1);
        lo_n = min(lo_n, min(lim_lo(op2, 1),
                             min(lim_lo(i2, 1), lim_lo(d2, 1))));
        hi_n = max(hi_n, max(lim_hi(op2, 1),
                             max(lim_hi(i2, 1), lim_hi(d2, 1))));
        all_null = all_null && op2.null_ && i2.null_ && d2.null_;
        int i2_ext, d2_ext;
        const int ins2 =
            gap_cell(at(op2, w - 1, W), at(i2, w - 1, W), 1, &i2_ext);
        const int del2 =
            gap_cell(at(op2, w + 1, W), at(d2, w + 1, W), 0, &d2_ext);
        // I2 and D2 are the last two of the five components
        arr[kComps - 2] = ins2;
        arr[kComps - 1] = del2;
        prod[kComps - 2] = !(op2.null_ && i2.null_);
        prod[kComps - 1] = !(op2.null_ && d2.null_);
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
    // edit and indel count no null steps (see the trim below)
    if (!kEditLike) nnull = all_null ? nnull + 1 : 0;
    if (mval < 0 || mval > tlen || mval - k < 0 || mval - k > plen) {
      mval = kNull;
    }
    // ends-free with a match bonus: seed the boundary at the scores
    // divisible by -match while the pair has any begin-free slack; on a
    // null step the wavefront is the seeds alone (and is not trimmed)
    bool null_step = all_null, seeded_null = false;
    if constexpr (kSeeding) {
      if (s1 % p.seed_div == 0 && (pbf > 0 || tbf > 0)) {
        const int ek = s1 / p.seed_div;
        const bool seed_t = tbf >= ek, seed_p = pbf >= ek;
        if (seed_t && k == ek && mval <= ek) {
          mval = ek;
          choice = MSRC_SEED;
        } else if (seed_p && k == -ek && mval <= 0) {
          mval = 0;
          choice = MSRC_SEED;
        }
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
    arr[M] = mval;

    const bool write = !null_step;
    const int klo = kmin + 2, khi = kmin + W - 3;
    const bool overflow = write && (lo_n < klo || hi_n > khi);
    lo_n = min(max(lo_n, klo), khi);
    hi_n = min(max(hi_n, klo), khi);
    const bool bandn = k >= lo_n && k <= hi_n;
    const bool band_n = bandn && write;

    prod[M] = write;
#pragma unroll
    for (int c = 1; c < kComps; ++c) prod[c] = prod[c] && write;
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      if (!(band_n && prod[c])) arr[c] = kNull;
      const int v = arr[c] - k;
      const bool inb = bandn && arr[c] >= 0 && arr[c] <= tlen && v >= 0 &&
                       v <= plen;
      const int wmin = __reduce_min_sync(0xFFFFFFFFu, inb ? w : W);
      const int wmax = __reduce_max_sync(0xFFFFFFFFu, inb ? w : -1);
      if (lane == 0) {
        red[c * 32 + warp] = wmin;
        red[(kComps + c) * 32 + warp] = wmax;
      }
    }
    __syncthreads();

    // end trim per component, then the ring write of score s + 1
#pragma unroll
    for (int c = 0; c < kComps; ++c) {
      int first = W, last = -1;
      for (int i = 0; i < nwarps; ++i) {
        first = min(first, red[c * 32 + i]);
        last = max(last, red[(kComps + c) * 32 + i]);
      }
      const bool keep = prod[c] && first < W;
      int tlo = keep ? first + kmin : 1;
      int thi = keep ? last + kmin : -1;
      if (kSeeding && c == M && seeded_null) {
        tlo = lo_n;
        thi = hi_n;
      }
      const int row = p.base[c] + slot1[c];
      off[row * W + w] = (k >= tlo && k <= thi) ? arr[c] : kNull;
      if (w == 0) {
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
    if (kRecord && band_n && choice != 0) {
      choices[static_cast<size_t>(s1) * BW] = static_cast<uint8_t>(choice);
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
  if (!done) {
    status = ST_OVERFLOW_S;
    final_s = s;
  }
  if (w == 0) {
    p.res[b] = status;
    p.res[p.B + b] = final_s;
    p.res[2 * p.B + b] = end_k;
    p.res[3 * p.B + b] = end_off;
  }
}

template <int kMetric, int kSpan, bool kRecord, bool kHeur>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(p.rows) * p.W + p.rows * 2 +
       (2 * n_comps(kMetric) + 1 + (kHeur ? kHeurReductions : 0)) * 32) *
      sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_loop<kMetric, kSpan, kRecord, kHeur>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_loop<kMetric, kSpan, kRecord, kHeur><<<p.B, p.W, smem, stream>>>(p);
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
// `metric` is one of the kMetric codes and `span` one of the kSpan codes;
// x, o1, e1, o2, e2 are the score distances of Params (an unused one is
// 0); `depths` is a host array of the ring's rows per component of the
// metric, M first (pywfa_tpu_torch/ops/fused_loop.py::ring_depths);
// `heur` is a host array of the cascade's nine parameters
// (::heuristic_params), whose first, the strategy bits, is 0 for the
// exact loop; seed_div is -match, read on the seeded span.
int wfa_fused_loop(const void* bits, const void* plen, const void* tlen,
                   const void* frees, void* choices, void* res,
                   const int* depths, int B, int W, int NQ, int S_cap,
                   int scope, int x, int o1, int e1, int o2, int e2,
                   int max_steps, int metric, int span, int record,
                   const int* heur, int seed_div, void* stream) {
  if (B == 0) return 0;
  if ((span != kEndToEnd && frees == nullptr) ||
      (record && choices == nullptr) || depths == nullptr ||
      heur == nullptr || metric < kAffine || metric > kIndel ||
      span < kEndToEnd || span > kSeeded ||
      (span == kSeeded && seed_div <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.bits = static_cast<const uint32_t*>(bits);
  p.plen = static_cast<const int32_t*>(plen);
  p.tlen = static_cast<const int32_t*>(tlen);
  p.frees = static_cast<const int32_t*>(frees);
  p.choices = static_cast<uint8_t*>(choices);
  p.res = static_cast<int32_t*>(res);
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
