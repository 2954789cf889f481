// Fused whole-alignment WFA score loop for Hopper (sm_90a): gap-affine,
// end-to-end or ends-free span (match == 0), full-CIGAR choice recording
// or score only, no heuristic.
//
// Replaces pywfa_tpu/ops/pallas/fused_loop.py::_kernel (its gap-affine
// branch without heuristics or ends-free match seeding) and both of its
// pallas_calls: the recording one and the score-only one. The plain torch
// version of the same program is
// pywfa_tpu_torch/ops/fused_loop.py::align_batch_fused_loop_ref; both
// produce byte-identical status, final_s, end_k, end_off and choices.
//
// Design: one thread block per pair, one thread per diagonal
// (blockDim = W, thread w owns k = kmin + w). The wavefront ring
// offsets[3 * scope][W] and its lo/hi pairs live in dynamic shared memory
// (27.6 KB at W = 256, scope = 9). Extension reads the packed equality
// words bits[q, b, w] from word off >> 5 upward and stops at the first
// mismatch (__ffs of the inverted word), with reads coalesced across w.
// The end trim takes its first/last in-bounds diagonal per component with
// warp reductions plus a shared-memory pass over the warps' partials.
// Each block leaves its loop as soon as its own pair is done.
//
// Two template parameters select the variant. kEndsFree seeds WF0 with
// the begin-free diagonals [-pattern_begin_free, text_begin_free] and ends
// at the lowest diagonal whose cell reached an end-free boundary: each
// warp ballots its hits, __ffs picks the warp's lowest, and a pass over
// the warps' partials in shared memory picks the block's. kRecord = false
// is the score-only scope: no choice bytes, no choices pointer.
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
constexpr int kComps = 3;  // M, I1, D1

constexpr int ST_END_REACHED = 1;
constexpr int ST_END_UNREACHABLE = 2;
constexpr int ST_MAX_STEPS = 3;
constexpr int ST_OVERFLOW_W = 4;
constexpr int ST_OVERFLOW_S = 5;

constexpr int MSRC_NONE = 0;
constexpr int MSRC_X = 1;
constexpr int MSRC_I1 = 2;
constexpr int MSRC_D1 = 3;

constexpr int M = 0;
constexpr int I1 = 1;
constexpr int D1 = 2;

struct Params {
  const uint32_t* bits;  // [NQ, B, W] packed equality words
  const int32_t* plen;   // [B]
  const int32_t* tlen;   // [B]
  const int32_t* frees;  // [B, 4]: pattern begin/end, text begin/end free
  uint8_t* choices;      // [S_cap, B, W], zero on entry; unused unless kRecord
  int32_t* res;          // [4, B]: status, final_s, end_k, end_off
  int B, W, NQ, S_cap, scope, x, o1e1, e1, max_steps;
};

// One wavefront of the ring: its row in shared memory (nullptr for a
// negative score, which reads as all-NULL) and its band.
struct Wf {
  const int* row;
  int lo, hi;
  bool null_;
};

__device__ __forceinline__ Wf read_wf(const int* off, const int* lohi,
                                      int comp, int score, int scope,
                                      int W) {
  Wf f;
  if (score < 0) {
    f.row = nullptr;
    f.lo = 1;
    f.hi = -1;
  } else {
    const int i = comp * scope + score % scope;
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

template <bool kEndsFree, bool kRecord>
__global__ void fused_loop_affine(Params p) {
  extern __shared__ int smem[];
  const int W = p.W;
  const int scope = p.scope;
  int* off = smem;                        // [kComps * scope][W]
  int* lohi = off + kComps * scope * W;   // [kComps * scope][2]
  int* red = lohi + kComps * scope * 2;   // [6][32] trim warp partials
  int* term = red + 6 * 32;               // [32] ends-free hit partials

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
  int wf0_lo = 0, wf0_hi = 0, pef = 0, tef = 0;
  if (kEndsFree) {
    const int32_t* fr = p.frees + 4 * static_cast<size_t>(b);
    wf0_lo = -fr[0];
    pef = fr[1];
    wf0_hi = fr[2];
    tef = fr[3];
  }
  for (int i = 0; i < kComps * scope; ++i) off[i * W + w] = kNull;
  off[M * W + w] = (k >= wf0_lo && k <= wf0_hi) ? max(k, 0) : kNull;
  for (int i = w; i < kComps * scope; i += W) {
    lohi[2 * i] = (i == 0) ? wf0_lo : 1;
    lohi[2 * i + 1] = (i == 0) ? wf0_hi : -1;
  }
  __syncthreads();

  // block-uniform state: every thread computes the same values
  int s = 0, status = 0, final_s = 0, end_k = 0, end_off = kNull;
  int nnull = 0;
  // seeds past the band: the pair escalates before its first step
  bool done = kEndsFree && (wf0_lo < kmin + 2 || wf0_hi > kmin + W - 3);
  if (done) status = ST_OVERFLOW_W;
  int m_lo = wf0_lo, m_hi = wf0_hi;  // band of M at score s

  while (!done && s < p.S_cap - 1) {
    int* m_row = off + (M * scope + s % scope) * W;
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

    // --- compute s + 1 ---
    const int s1 = s + 1;
    const int slot1 = s1 % scope;
    const Wf mm = read_wf(off, lohi, M, s1 - p.x, scope, W);
    const Wf op = read_wf(off, lohi, M, s1 - p.o1e1, scope, W);
    const Wf i1 = read_wf(off, lohi, I1, s1 - p.e1, scope, W);
    const Wf d1 = read_wf(off, lohi, D1, s1 - p.e1, scope, W);
    int lo_n = min(min(lim_lo(mm, 0), lim_lo(op, 1)),
                   min(lim_lo(i1, 1), lim_lo(d1, 1)));
    int hi_n = max(max(lim_hi(mm, 0), lim_hi(op, 1)),
                   max(lim_hi(i1, 1), lim_hi(d1, 1)));
    const bool all_null = mm.null_ && op.null_ && i1.null_ && d1.null_;

    // I1 / D1: open vs extend, extend wins ties; an all-invalid cell keeps
    // the raw shifted value, which only the bounds check below nulls
    const int op_l = at(op, w - 1, W), op_r = at(op, w + 1, W);
    const int i1_l = at(i1, w - 1, W), d1_r = at(d1, w + 1, W);
    const int i1p = max(pack(op_l + 1, 0), pack(i1_l + 1, 1));
    const int ins1 = i1p < 0 ? max(op_l, i1_l) + 1 : (i1p >> 3);
    const int i1_ext = (i1p >= 0 && (i1p & 7) == 1) ? 1 : 0;
    const int d1p = max(pack(op_r, 0), pack(d1_r, 1));
    const int del1 = d1p < 0 ? max(op_r, d1_r) : (d1p >> 3);
    const int d1_ext = (d1p >= 0 && (d1p & 7) == 1) ? 1 : 0;
    const int mis = at(mm, w, W) + 1;
    // M by the packed (value << 3) | prio max: X(5) > D1(3) > I1(1)
    const int pm = max(pack(mis, 5), max(pack(del1, 3), pack(ins1, 1)));
    const int raw = max(mis, max(del1, ins1));
    const int pr = pm & 7;
    const int msrc = pm < 0 ? MSRC_NONE
                            : (pr == 5 ? MSRC_X : (pr == 3 ? MSRC_D1 : MSRC_I1));
    const int choice = msrc | (i1_ext << 3) | (d1_ext << 4);
    nnull = all_null ? nnull + 1 : 0;
    int mval = pm < 0 ? raw : (pm >> 3);
    if (mval < 0 || mval > tlen || mval - k < 0 || mval - k > plen) {
      mval = kNull;
    }

    const bool write = !all_null;
    const int klo = kmin + 2, khi = kmin + W - 3;
    const bool overflow = write && (lo_n < klo || hi_n > khi);
    lo_n = min(max(lo_n, klo), khi);
    hi_n = min(max(hi_n, klo), khi);
    const bool bandn = k >= lo_n && k <= hi_n;
    const bool band_n = bandn && write;

    int arr[kComps] = {mval, ins1, del1};
    const bool prod[kComps] = {write, write && !(op.null_ && i1.null_),
                               write && !(op.null_ && d1.null_)};
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
      const int tlo = keep ? first + kmin : 1;
      const int thi = keep ? last + kmin : -1;
      const int slot = c * scope + slot1;
      off[slot * W + w] = (k >= tlo && k <= thi) ? arr[c] : kNull;
      if (w == 0) {
        lohi[2 * slot] = tlo;
        lohi[2 * slot + 1] = thi;
      }
      if (c == M) {
        m_lo = tlo;
        m_hi = thi;
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

template <bool kEndsFree, bool kRecord>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_loop_affine<kEndsFree, kRecord>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fused_loop_affine<kEndsFree, kRecord><<<p.B, p.W, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch the loop for B pairs on `stream`; returns the cudaError_t of the
// launch (0 on success). All pointers are device pointers; `frees` is
// read only when ends_free, `choices` written only when record.
int wfa_fused_loop_affine(const void* bits, const void* plen,
                          const void* tlen, const void* frees, void* choices,
                          void* res, int B, int W, int NQ, int S_cap,
                          int scope, int x, int o1e1, int e1, int max_steps,
                          int ends_free, int record, void* stream) {
  if (B == 0) return 0;
  if ((ends_free && frees == nullptr) || (record && choices == nullptr)) {
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
  p.x = x;
  p.o1e1 = o1e1;
  p.e1 = e1;
  p.max_steps = max_steps;
  const size_t smem =
      (static_cast<size_t>(kComps) * scope * W + kComps * scope * 2 + 7 * 32) *
      sizeof(int);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ends_free) {
    return record ? launch<true, true>(p, smem, st)
                  : launch<true, false>(p, smem, st);
  }
  return record ? launch<false, true>(p, smem, st)
                : launch<false, false>(p, smem, st);
}

const char* wfa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
