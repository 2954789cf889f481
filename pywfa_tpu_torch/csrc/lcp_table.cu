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
// either side and never a sentinel.
//
// Replaces pywfa_tpu/ops/pallas/lcp_table.py::_kernel and its
// pallas_call in build_lcp_table_hmajor. The plain torch version of the
// same function is
// pywfa_tpu_torch/ops/lcp_table.py::build_lcp_table_hmajor_ref; both give
// the same bytes. With the table the fused score loop (csrc/fused_loop.cu)
// extends a cell with one load, off += R[off, b, w].
//
// Design: a thread owns one diagonal (b, w) and walks h from Ltp - 1 down
// with the run in a register; the block's pair has its two rows staged in
// shared memory (a few KB), so the scan reads no device memory; at every
// h the block's threads write neighbouring w, so each store instruction
// of a warp is one contiguous run of 32 elements. Nothing of the TPU
// program's flipped pattern row, 128-position blocks or descending grid
// is carried over: those answer that machine's alignment rules.
//
// What bounds it: bytes, its output ([Ltp, B, W] elements, each written
// once; the two rows it reads are thousands of times smaller). Indices
// are size_t: Ltp * B * W passes 2^31 at shapes the long-read path uses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatternPad = 1;
constexpr int kTextPad = 2;
constexpr int kThreads = 256;

template <typename OutT>
__global__ void lcp_table(const int8_t* pat, const int8_t* txt, OutT* out,
                          int B, int W, int Lpp, int Ltp, int kmin,
                          int wildcard) {
  extern __shared__ int8_t rows[];
  int8_t* stxt = rows;        // [Ltp]
  int8_t* spat = rows + Ltp;  // [Lpp]
  const int b = blockIdx.y;
  const int8_t* gt = txt + static_cast<size_t>(b) * Ltp;
  const int8_t* gp = pat + static_cast<size_t>(b) * Lpp;
  for (int i = threadIdx.x; i < Ltp; i += blockDim.x) stxt[i] = gt[i];
  for (int i = threadIdx.x; i < Lpp; i += blockDim.x) spat[i] = gp[i];
  __syncthreads();
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int k = kmin + w;
  const size_t BW = static_cast<size_t>(B) * W;
  OutT* o = out + static_cast<size_t>(b) * W + w;
  int run = 0;
  for (int h = Ltp - 1; h >= 0; --h) {
    const int j = h - k;
    const int pc = (j >= 0 && j < Lpp) ? spat[j] : kPatternPad;
    const int tc = stxt[h];
    bool eq = pc == tc;
    if (wildcard >= 0) {
      eq = (eq || pc == wildcard || tc == wildcard) && pc != kPatternPad &&
           tc != kTextPad;
    }
    run = eq ? run + 1 : 0;
    o[static_cast<size_t>(h) * BW] = static_cast<OutT>(run);
  }
}

}  // namespace

extern "C" {

// Build R[Ltp, B, W] on `stream` from pat [B, Lpp] and txt [B, Ltp] int8
// rows; `out` holds uint8 when out_u8 (runs must fit: Ltp < 256) else
// int16 (Ltp < 32768). Returns the cudaError_t of the launch (0 on
// success). All pointers are device pointers.
int wfa_lcp_table(const void* pat, const void* txt, void* out, int B, int W,
                  int Lpp, int Ltp, int kmin, int wildcard, int out_u8,
                  void* stream) {
  if (B == 0 || W == 0 || Ltp == 0) return 0;
  if (pat == nullptr || txt == nullptr || out == nullptr || B > 65535 ||
      Ltp >= (out_u8 ? 256 : 32768) || Lpp + Ltp > 48 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  const size_t smem = static_cast<size_t>(Lpp) + Ltp;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(pat);
  const int8_t* t = static_cast<const int8_t*>(txt);
  if (out_u8) {
    lcp_table<uint8_t><<<grid, kThreads, smem, st>>>(
        p, t, static_cast<uint8_t*>(out), B, W, Lpp, Ltp, kmin, wildcard);
  } else {
    lcp_table<int16_t><<<grid, kThreads, smem, st>>>(
        p, t, static_cast<int16_t*>(out), B, W, Lpp, Ltp, kmin, wildcard);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* wfa_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
