// The traceback walk of one segment for Hopper (sm_90a): every pair steps
// backwards through its choice bytes from where the segment above left it,
// in one launch.
//
// Replaces no TPU kernel. The JAX package walks with XLA ops
// (pywfa_tpu/ops/engine.py), and the port first did the same: a host loop
// of some forty small torch launches a step with a host sync every few
// steps (ops/engine.py::walk_segment_ref, the plain version; both give the
// same bytes). That loop, not the card, set the walk's time: the device
// work of a step is one gather a pair.
//
// What bounds it: latency. A step of a pair is one dependent load of its
// choice byte at (level, pair, diagonal), which the previous step's score
// and diagonal address, then a table lookup and a one-byte store; a pair
// takes up to n_iter such steps one after another. The bytes moved are a
// few per step and the operations tens, so neither the card's bytes nor
// its operations come near to bounding it. The design keeps each step to
// that one load from device memory:
//
// - One thread a pair, a 1-D grid of small blocks (kThreads), so that a
//   few hundred pairs still spread over many SMs and each SM's warps hide
//   one another's loads.
// - The transition tables (what a (component, choice byte) step emits, its
//   diagonal delta, the next component and its kind) come packed one
//   32-bit word an entry (engine._walk_tables' "word"), at most 5 x 256 of
//   them, beside the entries' score deltas (its "ds", int32, so a penalty
//   of any size walks), and each block copies both into shared memory
//   first. Pairs look up different entries, which constant memory would
//   serialise.
// - Choice offsets are 64-bit: a record [K, B, W] may pass 2**31 bytes.
// - A pair stops once it leaves the segment, stops at a seed or score 0,
//   or falls back, and never after n_iter steps: the plain loop's result
//   without its syncs. Each thread zeroes its own ops row before it walks,
//   so no memset comes before the launch.
// - The most steps a pair took goes to `steps` (a warp's maximum, then one
//   atomic), only where the caller asks for it.
//
// The step, as the plain loop takes it, for a pair still in the segment
// (score s in [lowest, seg_base + K), active): its level s - seg_base; the
// choice byte at its diagonal k, 0 for a k outside the band; at component
// M, a stop at score 0 or at a seed (kind 1), an inconsistent chain where
// the byte has no source (kind 2); else a move, which writes its op at its
// level and steps s, k and the component, and falls back where it leaves
// s below 0. Level 0 of a segment that is not the bottom one aliases the
// top level of the segment below, which walks it: there lowest is
// seg_base + 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxEntries = 5 * 256;

// the fields of a table word (engine._walk_tables)
__device__ __forceinline__ int word_emit(uint32_t e) { return e & 0xff; }
__device__ __forceinline__ int word_kind(uint32_t e) { return (e >> 8) & 3; }
__device__ __forceinline__ int word_next(uint32_t e) { return (e >> 10) & 7; }
__device__ __forceinline__ int word_dk(uint32_t e) {
  return static_cast<int>((e >> 13) & 3) - 1;
}

__device__ __forceinline__ void zero_row(uint8_t* row, int K) {
  int i = 0;
  while (i < K && (reinterpret_cast<uintptr_t>(row + i) & 15) != 0) {
    row[i++] = 0;
  }
  for (; i + 16 <= K; i += 16) {
    *reinterpret_cast<uint4*>(row + i) = make_uint4(0, 0, 0, 0);
  }
  for (; i < K; ++i) row[i] = 0;
}

__global__ void __launch_bounds__(kThreads) walk(
    const uint8_t* __restrict__ choices, const uint32_t* __restrict__ table,
    const int32_t* __restrict__ table_ds, int entries,
    const int32_t* __restrict__ s_in,
    const int32_t* __restrict__ k_in, const int32_t* __restrict__ comp_in,
    const uint8_t* __restrict__ act_in, const uint8_t* __restrict__ fb_in,
    int32_t* __restrict__ s_out, int32_t* __restrict__ k_out,
    int32_t* __restrict__ comp_out, uint8_t* __restrict__ act_out,
    uint8_t* __restrict__ fb_out, uint8_t* __restrict__ ops,
    int32_t* __restrict__ steps, int K, int B, int W, int kmin, int seg_base,
    int n_iter) {
  __shared__ uint32_t tb[kMaxEntries];
  __shared__ int32_t tb_ds[kMaxEntries];
  for (int i = threadIdx.x; i < entries; i += blockDim.x) {
    tb[i] = table[i];
    tb_ds[i] = table_ds[i];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  int it = 0;
  if (b < B) {
    int s = s_in[b], k = k_in[b], comp = comp_in[b];
    bool act = act_in[b] != 0, fb = fb_in[b] != 0;
    uint8_t* row = ops + static_cast<size_t>(b) * K;
    zero_row(row, K);
    const long long lowest = seg_base > 0 ? seg_base + 1LL : 0LL;
    const long long top = static_cast<long long>(seg_base) + K;
    for (; it < n_iter; ++it) {
      if (!act || s < lowest || s >= top) break;
      const int lvl = s - seg_base;
      const int kk = k - kmin;
      uint32_t ch = 0;
      if (kk >= 0 && kk < W) {
        ch = choices[(static_cast<size_t>(lvl) * B + b) * W + kk];
      }
      const int t = comp * 256 + static_cast<int>(ch);
      const uint32_t e = tb[t];
      if (comp == 0) {
        const int kind = word_kind(e);
        if (s <= 0 || kind == 1) {  // a seed: the walk ends here
          act = false;
          ++it;
          break;
        }
        if (kind == 2) {  // no source: an inconsistent chain
          act = false;
          fb = true;
          ++it;
          break;
        }
      }
      row[lvl] = static_cast<uint8_t>(word_emit(e));
      s -= tb_ds[t];
      k += word_dk(e);
      comp = word_next(e);
      if (s < 0) {  // a chain pointing before score 0 is inconsistent
        act = false;
        fb = true;
        ++it;
        break;
      }
    }
    s_out[b] = s;
    k_out[b] = k;
    comp_out[b] = comp;
    act_out[b] = act;
    fb_out[b] = fb;
  }
  if (steps != nullptr) {
    const int most = __reduce_max_sync(0xffffffffu, it);
    if ((threadIdx.x & 31) == 0 && most > 0) atomicMax(steps, most);
  }
}

}  // namespace

extern "C" {

// Walk choices [K, B, W] uint8 (the levels of scores [seg_base, seg_base
// + K)) on `stream`, each pair from its carry (s, k, comp int32; act, fb
// one byte each, 0 or 1) in *_in to *_out (other buffers); writes every
// pair's ops row of ops [B, K] uint8, and where steps is not null the most
// steps a pair took to *steps (atomicMax: the caller zeroes it). table:
// `entries` words, 256 a component (256, 768 or 1280); table_ds: their
// score deltas, `entries` int32. n_iter: the most steps a pair may take. Returns the
// cudaError_t of the launch (0 on success; cudaErrorInvalidValue for what
// it does not take). All pointers are device pointers.
int wfa_walk(const void* choices, const void* table, const void* table_ds,
             int entries,
             const void* s_in, const void* k_in, const void* comp_in,
             const void* act_in, const void* fb_in, void* s_out, void* k_out,
             void* comp_out, void* act_out, void* fb_out, void* ops,
             void* steps, int K, int B, int W, int kmin, int seg_base,
             int n_iter, void* stream) {
  if (K < 0 || B < 0 || W < 0 || n_iter < 0 || seg_base < 0 ||
      (entries != 256 && entries != 768 && entries != kMaxEntries)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  if ((K > 0 && W > 0 && choices == nullptr) || (K > 0 && ops == nullptr) ||
      table == nullptr || table_ds == nullptr || s_in == nullptr || k_in == nullptr ||
      comp_in == nullptr || act_in == nullptr || fb_in == nullptr ||
      s_out == nullptr || k_out == nullptr || comp_out == nullptr ||
      act_out == nullptr || fb_out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  walk<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(choices),
      static_cast<const uint32_t*>(table),
      static_cast<const int32_t*>(table_ds), entries,
      static_cast<const int32_t*>(s_in), static_cast<const int32_t*>(k_in),
      static_cast<const int32_t*>(comp_in),
      static_cast<const uint8_t*>(act_in), static_cast<const uint8_t*>(fb_in),
      static_cast<int32_t*>(s_out), static_cast<int32_t*>(k_out),
      static_cast<int32_t*>(comp_out), static_cast<uint8_t*>(act_out),
      static_cast<uint8_t*>(fb_out), static_cast<uint8_t*>(ops),
      static_cast<int32_t*>(steps), K, B, W, kmin, seg_base, n_iter);
  return static_cast<int>(cudaGetLastError());
}

const char* wfa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
