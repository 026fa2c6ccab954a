// LSTM recurrence over precomputed input projections, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels ensemble_svs_with_interactions_tpu/ops/
// pallas_lstm.py:_lstm_kernel (hidden sequence only) and _lstm_fwd_kernel
// (hidden AND cell sequence, here the `cseq != nullptr` mode).
//
//   inputs : xw (B, T, 4H) f32 = x @ W_x + b (computed outside), wh (H, 4H) f32
//   outputs: y (B, T, H) f32 hidden states, optional cseq (B, T, H) cell states
//   gates  : i, f, g, o;  c' = sig(f) c + sig(i) tanh(g);  h' = sig(o) tanh(c')
//   carry  : h_0 = c_0 = 0, all f32.
//
// What bounds it: not bytes and not FLOPs.  Every step depends on the whole
// previous hidden vector, so the T steps run one after another; each step is
// a (B, H) x (H, 4H) product that is tiny next to the card, and its time is
// the latency of one step: reading h_{t-1}, the product, the cell update, and
// (for H > 64) a grid-wide barrier.
//
// Design.  The TPU kernel keeps one VMEM-resident W_h; on Hopper W_h is
// 4 MiB at H = 512 against 227 KB of shared memory per block.  So:
//   * the hidden units are split across the blocks of the grid (blockIdx.x);
//     a block owns the gate columns {j, H+j, 2H+j, 3H+j} of its U units, so
//     the cell update stays local, and keeps that (H, 4U) slice of W_h in
//     shared memory for the whole sequence (32 KB at H = 512, U = 4);
//   * at each step a block reads h_{t-1} of ALL units from the output y
//     (written by every block at step t-1, read through L2 with __ldcg),
//     computes its 4U gate sums for its batch rows, updates its cells,
//     writes h_t into y, and meets the other blocks at a grid barrier (a
//     monotonic atomic counter; the launch is cooperative, so every block
//     is resident and the spin cannot deadlock);
//   * at H <= 64 one block owns all units (W_h is 64 KB), h stays in shared
//     memory and no grid barrier is needed;
//   * batch rows are independent: groups of up to kMaxRows rows run as
//     separate grid rows (blockIdx.y), each with its own barrier counter;
//   * the xw values of step t+1 are loaded while step t finishes, so their
//     global-memory latency is off the critical path.
// Inside a block, thread (k, s) sums column k of W_h over the hidden units
// h = s, s+S, ...; the S partial sums meet with warp shuffles.  The shared
// W_h slice is stored column-major with a row pitch == S (mod 32), so the
// lanes of a warp hit distinct banks.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 4;  // batch rows per block

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every block of one batch group arrives once per step; step t is complete
// when the counter reaches nblk * (t + 1).
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (load_acquire(counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    lstm_recurrence_kernel(const float* __restrict__ xw,
                           const float* __restrict__ wh, float* y, float* cseq,
                           unsigned int* counters, int B, int T, int H, int U,
                           int S, int pitch) {
  extern __shared__ float smem[];
  const int K = 4 * U;
  const int H4 = 4 * H;
  float* ws = smem;                    // [K][pitch]: this block's W_h columns
  float* hs = ws + K * pitch;          // [kMaxRows][H]: h_{t-1}
  float* gs = hs + kMaxRows * H;       // [kMaxRows][K]: recurrent gate sums

  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int j0 = blockIdx.x * U;
  const int b0 = blockIdx.y * kMaxRows;
  const int rows = min(kMaxRows, B - b0);

  // column k of the slice is gate k / U of unit j0 + k % U
  for (int idx = tid; idx < K * H; idx += kThreads) {
    const int k = idx / H, h = idx - (idx / H) * H;
    const int j = j0 + k % U;
    ws[k * pitch + h] =
        (j < H) ? wh[(size_t)h * H4 + (k / U) * H + j] : 0.0f;
  }
  for (int idx = tid; idx < kMaxRows * H; idx += kThreads) hs[idx] = 0.0f;

  // gate-sum role: column k1, hidden units s1, s1 + S, ...
  const int k1 = tid / S, s1 = tid - (tid / S) * S;
  const bool dot_active = k1 < K;
  const float* wk = ws + (dot_active ? k1 : 0) * pitch;

  // cell role: batch row b2 of the group, unit j2
  const int b2 = tid / U, j2 = j0 + tid % U;
  const bool cell_active = tid < kMaxRows * U && b2 < rows && j2 < H;
  const float* xrow =
      cell_active ? xw + (size_t)(b0 + b2) * T * H4 + j2 : xw;
  float c = 0.0f;
  float xg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (cell_active) {
#pragma unroll
    for (int g = 0; g < 4; ++g) xg[g] = xrow[g * H];
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (nblk > 1 && t > 0) {
      for (int idx = tid; idx < rows * H; idx += kThreads) {
        const int b = idx / H, h = idx - (idx / H) * H;
        hs[b * H + h] = __ldcg(y + ((size_t)(b0 + b) * T + (t - 1)) * H + h);
      }
      __syncthreads();
    }

    float acc[kMaxRows];
#pragma unroll
    for (int b = 0; b < kMaxRows; ++b) acc[b] = 0.0f;
    if (dot_active) {
      for (int h = s1; h < H; h += S) {
        const float w = wk[h];
#pragma unroll
        for (int b = 0; b < kMaxRows; ++b)
          acc[b] = fmaf(hs[b * H + h], w, acc[b]);
      }
    }
    for (int off = S >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int b = 0; b < kMaxRows; ++b)
        acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], off);
    }
    if (dot_active && s1 == 0) {
#pragma unroll
      for (int b = 0; b < kMaxRows; ++b) gs[b * K + k1] = acc[b];
    }
    __syncthreads();

    if (cell_active) {
      const int u = tid % U;
      const float* g_row = gs + b2 * K;
      const float zi = xg[0] + g_row[u];
      const float zf = xg[1] + g_row[U + u];
      const float zg = xg[2] + g_row[2 * U + u];
      const float zo = xg[3] + g_row[3 * U + u];
      c = sigmoid_f32(zf) * c + sigmoid_f32(zi) * tanhf(zg);
      const float h = sigmoid_f32(zo) * tanhf(c);
      const size_t o = ((size_t)(b0 + b2) * T + t) * H + j2;
      y[o] = h;
      if (cseq != nullptr) cseq[o] = c;
      if (nblk == 1) hs[b2 * H + j2] = h;
      if (t + 1 < T) {
        const float* nxt = xrow + (size_t)(t + 1) * H4;
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = nxt[g * H];
      }
    }
    if (nblk > 1) {
      grid_barrier(counters + blockIdx.y, (unsigned int)(nblk * (t + 1)));
    } else {
      __syncthreads();
    }
  }
}

struct Plan {
  int U, nblk, S, pitch, groups;
  size_t smem;
};

Plan make_plan(int B, int H) {
  Plan p;
  p.U = H <= 64 ? H : std::max(4, (H + 127) / 128);
  p.nblk = (H + p.U - 1) / p.U;
  const int K = 4 * p.U;
  p.S = 1;
  while (p.S < 32 && K * p.S * 2 <= kThreads) p.S *= 2;
  p.pitch = H + (((p.S - H) % 32) + 32) % 32;
  p.groups = (B + kMaxRows - 1) / kMaxRows;
  p.smem = sizeof(float) *
           ((size_t)K * p.pitch + (size_t)kMaxRows * H + (size_t)kMaxRows * K);
  return p;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  `counters` must hold
// ceil(B / 4) zeroed uint32 values; `cseq` may be null.
int lstm_recurrence_launch(const float* xw, const float* wh, float* y,
                           float* cseq, unsigned int* counters, int B, int T,
                           int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  Plan p = make_plan(B, H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.nblk, p.groups);
  const cudaStream_t st = (cudaStream_t)stream;
  if (p.nblk == 1) {
    lstm_recurrence_kernel<<<grid, kThreads, p.smem, st>>>(
        xw, wh, y, cseq, counters, B, T, H, p.U, p.S, p.pitch);
    return (int)cudaGetLastError();
  }
  // the spin barrier needs every block resident at once
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, lstm_recurrence_kernel, kThreads, p.smem)) != cudaSuccess)
    return (int)err;
  if ((long long)per_sm * sms < (long long)p.nblk * p.groups)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&xw, (void*)&wh,    (void*)&y,   (void*)&cseq,
                  (void*)&counters, (void*)&B, (void*)&T, (void*)&H,
                  (void*)&p.U, (void*)&p.S,  (void*)&p.pitch};
  err = cudaLaunchCooperativeKernel((const void*)lstm_recurrence_kernel, grid,
                                    dim3(kThreads), args, p.smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Number of barrier counters the launch needs for a batch of B rows.
int lstm_recurrence_counters(int B) { return (B + kMaxRows - 1) / kMaxRows; }

const char* lstm_recurrence_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
