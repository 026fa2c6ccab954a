// Pieces shared by the LSTM recurrence kernels (lstm_recurrence.cu, the
// forward; lstm_bptt.cu, the reverse-time backward and dW_h): the
// activations, asynchronous global-to-shared copies, the grid-wide barrier
// of the multi-block kernels, the residency plan that keeps the group
// kernels' cooperative launches within what the card holds at once, and
// the 3xTF32 tensor-core product.  At H <= kSmallH the forward and the
// BPTT each have their own kernels, one block per batch row and no grid
// barrier.  At 64 < H <= kMaxGroupH both have a group kernel (kUnitsG
// units x a group of batch rows a block, W_h rows in registers), planned
// by plan_groups.  Above kMaxGroupH the forward and the BPTT loop are
// 3xTF32 mma.sync kernels (lstm_recurrence.cu, lstm_bptt.cu).
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace lstm {

constexpr int kThreads = 256;
constexpr int kSmallH = 64;  // widest H of the one-block-per-row kernels
constexpr int kMaxGroupH = 512;  // widest H of the group kernels
constexpr int kUnitsG = 16;      // units per block of the group kernels

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Activations from the hardware exp2 and reciprocal (ex2.approx.ftz,
// rcp.approx.ftz): a few ulp from expf and an IEEE division, which the card
// tests hold to 1e-4 over T = 6656 steps; they saturate to 0 / 1 and
// -1 / 1 as |x| grows (ex2 gives 0 or inf, rcp of inf gives 0).
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float sigmoid_fast(float x) {
  return rcp_approx(1.0f + ex2_approx(-kLog2e * x));
}

__device__ __forceinline__ float tanh_fast(float x) {
  return 1.0f - 2.0f * rcp_approx(1.0f + ex2_approx(2.0f * kLog2e * x));
}

// cp.async (sm_80+): copy global -> shared without a register round trip.
// `bytes` < the copy size zero-fills the rest (0: nothing is read, and
// `src` need only be a valid address).  The 16-byte form bypasses L1 (.cg)
// and needs 16-byte aligned addresses; the 4-byte form takes any float.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes = 16) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight;
// a __syncthreads after it makes every thread's finished copies visible.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One step of a reduce-scatter over the lanes `mask` apart: v[0, 2 kHalf)
// becomes v[0, kHalf), the sums of the half this lane keeps (the upper one
// where `upper`), its partner keeping the other.
template <int kHalf>
__device__ __forceinline__ void reduce_half(float* v, int mask, bool upper) {
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = upper ? v[i + kHalf] : v[i];
    const float send = upper ? v[i] : v[i + kHalf];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every block of one grid row arrives once per step; step s is complete
// when the row's counter reaches nblk * (s + 1).
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

// The same barrier with the arrival as one release reduction and the wait
// as acquire loads, and no fences: the __syncthreads before the release
// orders the block's writes before it, and the one after the acquire
// orders every read of the block after it (the arrive / wait pattern of
// CUTLASS's GenericBarrier).  The forward's kernels above kSmallH and the
// BPTT loop above kMaxGroupH use it.
__device__ __forceinline__ void grid_barrier_release(unsigned int* counter,
                                                     unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(counter),
                 "r"(1u)
                 : "memory");
    while (load_acquire(counter) < target) {
    }
  }
  __syncthreads();
}

// The group kernels' plan.  Groups of rows go to grid rows.  Every block
// of the cooperative launch must be resident at once, so when nblk blocks
// per group do not fit, each grid row takes gpb groups in turn (its shared
// memory, smem_for(gpb), growing by one carried vector a group).
struct GroupPlan {
  int gpb, grid_rows;
  size_t smem;
};

template <typename Kernel, typename SmemFor>
cudaError_t plan_groups(Kernel kernel, int groups, int nblk, SmemFor smem_for,
                        GroupPlan* out) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  for (int gpb = 1;;) {
    const size_t smem = smem_for(gpb);
    int per_sm = 0;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
             (int)smem)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return err;
    const int rows_fit = std::min(groups, per_sm * sms / nblk);
    if (rows_fit < 1) return cudaErrorCooperativeLaunchTooLarge;
    const int need = (groups + rows_fit - 1) / rows_fit;
    if (need <= gpb) {
      *out = {gpb, (groups + gpb - 1) / gpb, smem};
      return cudaSuccess;
    }
    gpb = need;
  }
}

// 3xTF32: a float32-accurate product on the TF32 tensor cores (the
// precision argument stands above lstm_dwh_kernel in lstm_bptt.cu).  hi keeps the sign, exponent
// and 10 mantissa bits of x (a TF32 value); lo = x - hi is exact in f32,
// and the tensor core reads its top 19 bits.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b for one m16n8k8 TF32 tile (fragments as the PTX ISA lays them
// out: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); b0
// (t, g), b1 (t + 4, g); d0, d1 (g, 2t, 2t + 1), d2, d3 (g + 8, ...), for
// lane 4 g + t).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace lstm
