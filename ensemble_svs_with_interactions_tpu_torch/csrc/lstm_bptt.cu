// Reverse-time BPTT for the LSTM recurrence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ensemble_svs_with_interactions_tpu/ops/
// pallas_lstm.py:_lstm_bwd_kernel (launched by _recurrence_bwd_pallas), the
// backward of the custom VJP lstm_recurrence_trainable.  Two kernels:
//
//   lstm_bptt_kernel: dz = dxw (B, T, 4H), the gate gradient, in reverse time
//     inputs : xw (B, T, 4H), wh (H, 4H), h and c (B, T, H) from the forward,
//              dy (B, T, H) the gradient into h
//     step t : recompute the gates from xw_t + h_{t-1} W_h;
//              dh = dy_t + dz_{t+1} W_h^T;  dc = dh o (1 - tanh^2 c_t) + dc_next;
//              dz_i = dc g i (1-i), dz_f = dc c_{t-1} f (1-f),
//              dz_g = dc i (1-g^2), dz_o = dh tanh(c_t) o (1-o);  dc_next = dc f
//   lstm_dwh_kernel (+ lstm_dwh_reduce_kernel): dW_h = sum over (b, t) of
//     h_{t-1}^T dz_t, a tiled reduction over the B(T-1) steps with t >= 1
//     (h_{-1} = 0), split over the reduction and summed in a fixed order.
//
// What bounds it.  The BPTT loop is latency bound like the forward (each
// step needs dz_{t+1} of all 4H columns) and does twice the forward's
// multiply-adds per step: the gate recompute and dz W_h^T.  dW_h is a
// (H x B(T-1)) x (B(T-1) x 4H) product, operations bound: on the float32
// SIMT rate (67 TFLOP/s) for a plain kernel, on the TF32 tensor cores'
// rate over 3 (495 / 3 = 165 TFLOP/s of float32-accurate products) for the
// 3xTF32 kernel here, whose design and precision argument stand above it.
//
// Design.  The multi-block forward's layout carries over (at H <= 64 as one
// block with every unit; the forward's own H <= 64 kernel is another
// design): a block owns the gate columns
// {j, H+j, 2H+j, 3H+j} of U hidden units for a group of batch rows, and
// keeps two slices of W_h in shared memory for the whole sequence: those
// columns (H x 4U, for the recompute) and the rows of its units (U x 4H,
// for dz W_h^T; 32 KB each at H = 512, U = 4).  At each step it writes its
// columns of dz into dxw[:, t], meets the other blocks at a grid barrier
// and reads the whole dxw[:, t] back through L2 (__ldcg) for the next
// step's dh.  Residency follows the forward's plan (lstm_common.cuh).
// dW_h is a second kernel, not an accumulation inside the loop: the loop's
// blocks split the batch, so an in-loop sum would need a cross-block pass
// anyway, and a separate tiled product keeps work off the sequential path.
// Padding needs no mask: the layer zeroes its outputs at padded steps, so dy
// is 0 there, and padding is a suffix, so dh and dc enter the valid steps
// as 0.

#include "lstm_common.cuh"

namespace {

using namespace lstm;

// Copy `rows` rows of `width` elements, `stride` elements apart in global
// memory, into consecutive rows of `dst` in shared memory.  Each thread
// issues up to kBatch loads before it stores any, so a copy costs about one
// round trip to L2 rather than one per element.  kCg reads through L2 only
// (__ldcg), for data that other blocks wrote during this launch.
template <typename V, bool kCg>
__device__ __forceinline__ void load_rows(V* dst, const V* src, size_t stride,
                                          int rows, int width) {
  constexpr int kBatch = 8;
  const int n = rows * width;
  for (int base = threadIdx.x; base < n; base += kBatch * kThreads) {
    V v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int idx = base + i * kThreads;
      if (idx < n) {
        const int r = idx / width;
        const V* p = src + r * stride + (idx - r * width);
        v[i] = kCg ? __ldcg(p) : __ldg(p);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int idx = base + i * kThreads;
      if (idx < n) dst[idx] = v[i];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    lstm_bptt_kernel(const float* __restrict__ xw,
                     const float* __restrict__ wh,
                     const float* __restrict__ hseq,
                     const float* __restrict__ cseq,
                     const float* __restrict__ dy, float* dxw,
                     unsigned int* counters, int B, int T, int H, int U, int S,
                     int pitch, int S2, int pitch2, int gpb) {
  extern __shared__ __align__(16) float smem[];
  const int K = 4 * U;
  const int H4 = 4 * H;
  const int R = gpb * kMaxRows;
  const int W = S2 > 32 ? S2 / 32 : 1;  // warps per unit in the dh sums
  float* wc = smem;                  // [K][pitch]: W_h columns of own gates
  float* wr = wc + K * pitch;        // [U][pitch2]: W_h rows of own units
  float* ds = wr + U * pitch2;       // [kMaxRows][4H]: dz_{t+1} of one group
  float* hs = ds + kMaxRows * H4;    // [kMaxRows][H]: h_{t-1} of one group
  float* gs = hs + kMaxRows * H;     // [R][K]: recomputed recurrent gate sums
  float* es = gs + R * K;            // [R][U][W]: dz_{t+1} W_h^T, per warp

  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int j0 = blockIdx.x * U;
  const int b0 = blockIdx.y * R;
  const int rows = min(R, B - b0);
  const int ngroups = (rows + kMaxRows - 1) / kMaxRows;

  for (int idx = tid; idx < K * H; idx += kThreads) {
    const int k = idx / H, h = idx - (idx / H) * H;
    const int j = j0 + k % U;
    wc[k * pitch + h] =
        (j < H) ? wh[(size_t)h * H4 + (k / U) * H + j] : 0.0f;
  }
  for (int idx = tid; idx < U * H4; idx += kThreads) {
    const int u = idx / H4, n = idx - (idx / H4) * H4;
    wr[u * pitch2 + n] = (j0 + u < H) ? wh[(size_t)(j0 + u) * H4 + n] : 0.0f;
  }

  for (int idx = tid; idx < kMaxRows * H4; idx += kThreads) ds[idx] = 0.0f;

  // gate-sum role: column k1 over hidden units s1, s1 + S, ...
  const int k1 = tid / S, s1 = tid - (tid / S) * S;
  const bool dot_active = k1 < K;
  const float* wk = wc + (dot_active ? k1 : 0) * pitch;
  // dh role: own unit u3 over gate columns s3, s3 + S2, ... (S2 lanes,
  // W warps when S2 > 32)
  const int u3 = tid / S2, s3 = tid - (tid / S2) * S2;
  const bool dh_active = u3 < U;
  const float* wu = wr + (dh_active ? u3 : 0) * pitch2;
  // cell role: batch row b2 of the grid row, unit j2
  const int b2 = tid / U, u2 = tid % U, j2 = j0 + u2;
  const bool cell_active = tid < R * U && b2 < rows && j2 < H;
  const size_t row = (size_t)(b0 + (cell_active ? b2 : 0)) * T;

  // the cell thread's operands of step t, loaded one step ahead
  float xg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float c_t = 0.0f, c_prev = 0.0f, dy_t = 0.0f, dc_next = 0.0f;
  if (cell_active) {
    const int t = T - 1;
#pragma unroll
    for (int g = 0; g < 4; ++g) xg[g] = xw[(row + t) * H4 + g * H + j2];
    c_t = cseq[(row + t) * H + j2];
    c_prev = t > 0 ? cseq[(row + t - 1) * H + j2] : 0.0f;
    dy_t = dy[(row + t) * H + j2];
  }
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    for (int grp = 0; grp < ngroups; ++grp) {
      const int gb = grp * kMaxRows;
      const int grows = min(kMaxRows, rows - gb);
      // dz_{t+1} of the group's rows (rows past `grows` keep stale values:
      // their sums land in gs / es rows that no cell thread reads)
      if (t + 1 < T) {
        load_rows<float4, true>(
            reinterpret_cast<float4*>(ds),
            reinterpret_cast<const float4*>(
                dxw + ((size_t)(b0 + gb) * T + t + 1) * H4),
            (size_t)T * H, grows, H);
      }
      if (t > 0) {
        load_rows<float, false>(hs, hseq + ((size_t)(b0 + gb) * T + t - 1) * H,
                                (size_t)T * H, grows, H);
      } else {
        for (int idx = tid; idx < kMaxRows * H; idx += kThreads) hs[idx] = 0.0f;
      }
      __syncthreads();

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
        for (int b = 0; b < kMaxRows; ++b) gs[(gb + b) * K + k1] = acc[b];
      }

      float acc2[kMaxRows];
#pragma unroll
      for (int b = 0; b < kMaxRows; ++b) acc2[b] = 0.0f;
      if (dh_active) {
        for (int n = s3; n < H4; n += S2) {
          const float w = wu[n];
#pragma unroll
          for (int b = 0; b < kMaxRows; ++b)
            acc2[b] = fmaf(ds[b * H4 + n], w, acc2[b]);
        }
      }
      for (int off = min(S2, 32) >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int b = 0; b < kMaxRows; ++b)
          acc2[b] += __shfl_xor_sync(0xffffffffu, acc2[b], off);
      }
      if (dh_active && (s3 & 31) == 0) {
#pragma unroll
        for (int b = 0; b < kMaxRows; ++b)
          es[((gb + b) * U + u3) * W + s3 / 32] = acc2[b];
      }
      __syncthreads();
    }

    if (cell_active) {
      const float* g_row = gs + b2 * K;
      const float i = sigmoid_f32(xg[0] + g_row[u2]);
      const float f = sigmoid_f32(xg[1] + g_row[U + u2]);
      const float g = tanhf(xg[2] + g_row[2 * U + u2]);
      const float o = sigmoid_f32(xg[3] + g_row[3 * U + u2]);
      const float tc = tanhf(c_t);
      float dh = dy_t;
      for (int w = 0; w < W; ++w) dh += es[(b2 * U + u2) * W + w];
      const float dc = dh * o * (1.0f - tc * tc) + dc_next;
      float* dz = dxw + (row + t) * H4 + j2;
      dz[0] = dc * g * i * (1.0f - i);
      dz[H] = dc * c_prev * f * (1.0f - f);
      dz[2 * H] = dc * i * (1.0f - g * g);
      dz[3 * H] = dh * tc * o * (1.0f - o);
      dc_next = dc * f;
      if (t > 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xg[q] = xw[(row + t - 1) * H4 + q * H + j2];
        c_t = c_prev;
        c_prev = t > 1 ? cseq[(row + t - 2) * H + j2] : 0.0f;
        dy_t = dy[(row + t - 1) * H + j2];
      }
    }
    if (nblk > 1) {
      grid_barrier(counters + blockIdx.y, (unsigned int)(nblk * (T - t)));
    } else {
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------- dW_h
// C (H, 4H) = sum over m = (b, tt), tt < T - 1, of A[m]^T B[m], with
// A[m] = h[b, tt, :] and B[m] = dz[b, tt + 1, :]: both operands have the
// reduction as their outer dimension and the output dimensions contiguous.
//
// Block tile kBI hidden units x kBN = 128 gate columns (kBI = 128, or 64 at
// H <= 64, where H fills no more), 8 warps as 2 (units) x 4 (columns), each
// warp (kBI / 2) x 32 of mma.sync.m16n8k8 TF32 tiles.  The reduction walks
// batch row b, then step tt, kBK = 16 steps per k-tile: a tile row is one
// contiguous run of h and one of dz, whose address each loading thread
// advances once per k-tile (no division per element).  Tiles stream
// through a kStagesD-deep cp.async ring, 16-byte copies where rows and
// pointers are 16-byte aligned (H % 4 == 0), 4-byte copies otherwise;
// ragged edges are zero-filled by the copy.
// Shared rows have a pitch == 8 (mod 32) floats, so the fragment loads of a
// warp hit 32 distinct banks.
//
// 3xTF32: each operand x is split into a TF32 high part hi (x with its 13
// low mantissa bits cleared, one AND) and the remainder lo = x - hi, exact
// in f32 with |lo| < 2^-10 |x|; the tensor core reads lo as TF32, dropping
// its own 13 low bits, an error below 2^-10 |lo| < 2^-20 |x|.  a b is
// taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (small terms first); TF32 x
// TF32 products are exact in f32, and the dropped lo_a lo_b and truncation
// terms stay below 2^-18 |a b|.  The tensor core's f32 accumulator does not
// round to nearest, and its error grows with the number of products summed
// into one register, so it only sums one k8 step (8 products x 3 terms)
// from zero; an ordinary f32 add, rounded to nearest, adds that partial to
// the running sum, which then loses what a float32 SIMT sum loses.  The
// card tests hold dW_h to 1e-4 of its largest entry, as they held the
// float32 SIMT kernel.
//
// blockIdx.z takes one slice of the reduction; with more than one slice the
// partial sums go to `out` [splits][H][4H] and lstm_dwh_reduce_kernel adds
// them in slice order: deterministic, no atomics.  One block per SM: its
// 128 x 128 tile's accumulators, fragments and per-k8 partials need about
// 220 registers, and two blocks per SM (128 registers each) spilled and ran
// slower.  At the flagship shapes it reaches about a third of the 3xTF32
// bound, and a 128 x 256 tile, with half the fragment loads and splits per
// product, does no better: the limit is not the operand traffic but, most
// likely, the legacy mma.sync path.  Hopper's full tensor-core rate needs
// wgmma, a later design.
constexpr int kBK = 16;
constexpr int kBN = 128;
constexpr int kStagesD = 3;
constexpr int kPadD = 8;
constexpr int kThreadsD = 256;
constexpr int kMinRun = 256;  // reduction rows per slice, at least

// hi keeps the sign, exponent and 10 mantissa bits of x (a TF32 value);
// lo = x - hi is exact in f32, and the tensor core reads its top 19 bits.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int kBI>
constexpr size_t dwh_smem_bytes() {
  return sizeof(float) * kStagesD * kBK * ((kBI + kPadD) + (kBN + kPadD));
}

template <int kBI, bool kVec>
__global__ void __launch_bounds__(kThreadsD, 1)
    lstm_dwh_kernel(const float* __restrict__ hseq,
                    const float* __restrict__ dz, float* out, int B, int T,
                    int H, int m_per_split) {
  constexpr int PA = kBI + kPadD, PB = kBN + kPadD;
  constexpr int MT = kBI / 32;  // m16 tiles per warp
  constexpr int NQ = kBN / 32;  // n8 tiles per warp
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                         // [kStagesD][kBK][PA]: h
  float* Bs = smem + kStagesD * kBK * PA;   // [kStagesD][kBK][PB]: dz

  const int H4 = 4 * H;
  const int M = B * (T - 1);
  const int Tm = max(T - 1, 1);  // T = 1: M = 0, no tile is loaded
  const int i0 = blockIdx.y * kBI, n0 = blockIdx.x * kBN;
  const int m_begin = blockIdx.z * m_per_split;
  const int m_end = min(M, m_begin + m_per_split);
  const int ktiles = max(0, (m_end - m_begin + kBK - 1) / kBK);

  // loading role: reduction row kr of every tile, columns from lane c16
  const int kr = threadIdx.x >> 4, c16 = threadIdx.x & 15;
  int m = m_begin + kr;
  int b = m / Tm, tt = m - (m / Tm) * Tm;

  auto load_tile = [&](int stage) {
    const bool valid = m < m_end;
    const size_t step = (size_t)b * T + tt;
    const float* arow = hseq + step * H;
    const float* brow = dz + (step + 1) * H4;
    float* ad = As + (stage * kBK + kr) * PA;
    float* bd = Bs + (stage * kBK + kr) * PB;
    if (kVec) {
#pragma unroll
      for (int j = 0; j < kBI / 64; ++j) {
        const int col = 4 * (c16 + 16 * j);
        const bool in = valid && i0 + col < H;
        cp_async16(ad + col, in ? arow + i0 + col : hseq, in ? 16 : 0);
      }
#pragma unroll
      for (int j = 0; j < kBN / 64; ++j) {
        const int col = 4 * (c16 + 16 * j);
        const bool in = valid && n0 + col < H4;
        cp_async16(bd + col, in ? brow + n0 + col : dz, in ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kBI / 16; ++j) {
        const int col = c16 + 16 * j;
        const bool in = valid && i0 + col < H;
        cp_async4(ad + col, in ? arow + i0 + col : hseq, in ? 4 : 0);
      }
#pragma unroll
      for (int j = 0; j < kBN / 16; ++j) {
        const int col = c16 + 16 * j;
        const bool in = valid && n0 + col < H4;
        cp_async4(bd + col, in ? brow + n0 + col : dz, in ? 4 : 0);
      }
    }
    // the next k-tile's row: kBK steps on, across batch rows as needed
    m += kBK;
    tt += kBK;
    while (tt >= Tm) {
      tt -= Tm;
      ++b;
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wi = (warp >> 2) * (kBI / 2), wn = (warp & 3) * (kBN / 4);
  const int gid = lane >> 2, tig = lane & 3;
  float acc[MT][NQ][4];
#pragma unroll
  for (int p = 0; p < MT; ++p)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][q][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStagesD - 1; ++st) {
    if (st < ktiles) load_tile(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStagesD - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + kStagesD - 1 < ktiles) load_tile((kt + kStagesD - 1) % kStagesD);
    cp_async_commit();
    const float* as = As + (kt % kStagesD) * kBK * PA + wi + gid;
    const float* bs = Bs + (kt % kStagesD) * kBK * PB + wn + gid;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      const float* a0 = as + (kk + tig) * PA;
      const float* a4 = a0 + 4 * PA;
      const float* b0 = bs + (kk + tig) * PB;
      const float* b4 = b0 + 4 * PB;
      unsigned bh[NQ][2], bl[NQ][2];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        split_tf32(b0[8 * q], bh[q][0], bl[q][0]);
        split_tf32(b4[8 * q], bh[q][1], bl[q][1]);
      }
#pragma unroll
      for (int p = 0; p < MT; ++p) {
        unsigned ah[4], al[4];
        split_tf32(a0[16 * p], ah[0], al[0]);
        split_tf32(a0[16 * p + 8], ah[1], al[1]);
        split_tf32(a4[16 * p], ah[2], al[2]);
        split_tf32(a4[16 * p + 8], ah[3], al[3]);
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_tf32(d, al, bh[q]);
          mma_tf32(d, ah, bl[q]);
          mma_tf32(d, ah, bh[q]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[p][q][e] += d[e];
        }
      }
    }
  }
  cp_async_wait<0>();

  float* slab = out + (size_t)blockIdx.z * H * H4;
#pragma unroll
  for (int p = 0; p < MT; ++p) {
    const int i = i0 + wi + 16 * p + gid;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int n = n0 + wn + 8 * q + 2 * tig;  // even, and H4 is even
      if (n >= H4) continue;
      if (i < H)
        *reinterpret_cast<float2*>(slab + (size_t)i * H4 + n) =
            make_float2(acc[p][q][0], acc[p][q][1]);
      if (i + 8 < H)
        *reinterpret_cast<float2*>(slab + (size_t)(i + 8) * H4 + n) =
            make_float2(acc[p][q][2], acc[p][q][3]);
    }
  }
}

// dwh = part[0] + part[1] + ... in slice order, 4 floats a thread; the
// unrolled loop keeps several slices' loads in flight ahead of the sums.
__global__ void lstm_dwh_reduce_kernel(const float4* __restrict__ part,
                                       float4* dwh, int splits, int size4) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= size4) return;
  float4 s = part[idx];
#pragma unroll 8
  for (int z = 1; z < splits; ++z) {
    const float4 v = part[(size_t)z * size4 + idx];
    s.x += v.x;
    s.y += v.y;
    s.z += v.z;
    s.w += v.w;
  }
  dwh[idx] = s;
}

template <int kBI, bool kVec>
cudaError_t launch_dwh(const float* h, const float* dz, float* out, int B,
                       int T, int H, int splits, int m_per_split,
                       cudaStream_t st) {
  constexpr size_t smem = dwh_smem_bytes<kBI>();
  cudaError_t err = cudaFuncSetAttribute(
      lstm_dwh_kernel<kBI, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((4 * H + kBN - 1) / kBN, (H + kBI - 1) / kBI, splits);
  lstm_dwh_kernel<kBI, kVec><<<grid, kThreadsD, smem, st>>>(
      h, dz, out, B, T, H, m_per_split);
  return cudaGetLastError();
}

struct BpttPlan {
  Split p;
  int S2, pitch2;
};

// dh sums: S2 lanes per unit (a power of two, U * S2 <= kThreads), over
// one or more warps.  W_h's row slice has a pitch == S2 (mod 32), which
// spreads the units a warp covers over the banks and keeps the float4
// alignment of the dz rows that follow it.
BpttPlan make_bptt_plan(int H) {
  BpttPlan q;
  q.p = make_split(H);
  q.S2 = 1;
  while (q.p.U * q.S2 * 2 <= kThreads) q.S2 *= 2;
  q.pitch2 = 4 * H + (((q.S2 - 4 * H) % 32) + 32) % 32;
  return q;
}

size_t bptt_smem_bytes(const BpttPlan& q, int H, int gpb) {
  const int U = q.p.U, K = 4 * U;
  const size_t R = (size_t)gpb * kMaxRows;
  const size_t W = q.S2 > 32 ? q.S2 / 32 : 1;
  return sizeof(float) * ((size_t)K * q.p.pitch + (size_t)U * q.pitch2 +
                          (size_t)kMaxRows * H + (size_t)kMaxRows * 4 * H +
                          R * K + R * U * W);
}

}  // namespace

extern "C" {

// dz into dxw (B, T, 4H).  Returns a cudaError_t (0 on success).
// `counters` must hold lstm_bptt_counters(B) zeroed uint32 values.
int lstm_bptt_launch(const float* xw, const float* wh, const float* h,
                     const float* c, const float* dy, float* dxw,
                     unsigned int* counters, int B, int T, int H,
                     void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const BpttPlan q = make_bptt_plan(H);
  Rows r;
  cudaError_t err = plan_rows(
      lstm_bptt_kernel, B, q.p.U, q.p.nblk,
      [&](int gpb) { return bptt_smem_bytes(q, H, gpb); }, &r);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = bptt_smem_bytes(q, H, r.gpb);
  err = cudaFuncSetAttribute(lstm_bptt_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(q.p.nblk, r.grid_rows);
  const cudaStream_t st = (cudaStream_t)stream;
  int U = q.p.U, S = q.p.S, pitch = q.p.pitch, S2 = q.S2, pitch2 = q.pitch2,
      gpb = r.gpb;
  if (q.p.nblk == 1) {
    lstm_bptt_kernel<<<grid, kThreads, smem, st>>>(
        xw, wh, h, c, dy, dxw, counters, B, T, H, U, S, pitch, S2, pitch2,
        gpb);
    return (int)cudaGetLastError();
  }
  void* args[] = {(void*)&xw,     (void*)&wh, (void*)&h,      (void*)&c,
                  (void*)&dy,     (void*)&dxw, (void*)&counters, (void*)&B,
                  (void*)&T,      (void*)&H,  (void*)&U,      (void*)&S,
                  (void*)&pitch,  (void*)&S2, (void*)&pitch2, (void*)&gpb};
  err = cudaLaunchCooperativeKernel((const void*)lstm_bptt_kernel, grid,
                                    dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int lstm_bptt_counters(int B) { return (B + kMaxRows - 1) / kMaxRows; }

// Number of reduction slices lstm_dwh_launch uses: enough blocks to fill
// the card once at the kernel's one block per SM, each slice at least
// kMinRun steps long.  With more than one, the caller passes `part` of
// splits * H * 4H floats.
int lstm_dwh_splits(int B, int T, int H) {
  const int M = B * (T - 1);
  const int bi = H <= 64 ? 64 : 128;
  const int tiles = ((4 * H + kBN - 1) / kBN) * ((H + bi - 1) / bi);
  int sms = 132;
  sm_count(&sms);
  const int splits = std::min(sms / tiles, (M + kMinRun - 1) / kMinRun);
  return std::max(splits, 1);
}

// dwh (H, 4H) = sum over b and t >= 1 of h[b, t-1]^T dz[b, t].
int lstm_dwh_launch(const float* h, const float* dz, float* dwh, float* part,
                    int B, int T, int H, int splits, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int M = B * (T - 1);
  const int m_per_split =
      std::max(kBK, ((M + splits - 1) / splits + kBK - 1) / kBK * kBK);
  const cudaStream_t st = (cudaStream_t)stream;
  float* out = splits > 1 ? part : dwh;
  const bool vec = H % 4 == 0 && aligned16(h) && aligned16(dz);
  const auto launch =
      H <= 64 ? (vec ? launch_dwh<64, true> : launch_dwh<64, false>)
              : (vec ? launch_dwh<128, true> : launch_dwh<128, false>);
  cudaError_t err = launch(h, dz, out, B, T, H, splits, m_per_split, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int size4 = H * H;  // H x 4H floats as float4
  lstm_dwh_reduce_kernel<<<(size4 + kThreads - 1) / kThreads, kThreads, 0,
                           st>>>(reinterpret_cast<const float4*>(part),
                                 reinterpret_cast<float4*>(dwh), splits,
                                 size4);
  return (int)cudaGetLastError();
}

const char* lstm_bptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
