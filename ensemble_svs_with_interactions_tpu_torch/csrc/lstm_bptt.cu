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
// step needs dz_{t+1} of all 4H columns) and does three times the
// forward's multiply-adds per step: the gate recompute, dz W_h^T, and (in
// the second kernel) h^T dz.  dW_h is a (H x B(T-1)) x (B(T-1) x 4H)
// product, operations bound on the card's float32 rate.
//
// Design.  The forward's layout carries over: a block owns the gate columns
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

// dW_h tile: 64 rows (hidden units i) x 64 columns (gate columns n) per
// block; each thread accumulates a 4 x 4 micro-tile of outer products over
// 16 reduction steps at a time.  blockIdx.z takes one slice of the
// reduction; with more than one slice the partial sums go to `out`
// [splits][H][4H] and lstm_dwh_reduce_kernel adds them in slice order.
constexpr int kTile = 64;
constexpr int kTileK = 16;

__global__ void __launch_bounds__(kThreads)
    lstm_dwh_kernel(const float* __restrict__ hseq,
                    const float* __restrict__ dz, float* out, int B, int T,
                    int H, int m_per_split) {
  __shared__ __align__(16) float ha[kTileK][kTile];  // h_{t-1}[m][i]
  __shared__ __align__(16) float za[kTileK][kTile];  // dz_t[m][n]
  const int H4 = 4 * H;
  const int Tm = T - 1;
  const int M = B * Tm;
  const int i0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int m_begin = blockIdx.z * m_per_split;
  const int m_end = min(M, m_begin + m_per_split);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  for (int m0 = m_begin; m0 < m_end; m0 += kTileK) {
    for (int e = threadIdx.x; e < kTileK * kTile; e += kThreads) {
      const int mk = e / kTile, col = e - (e / kTile) * kTile;
      const int m = m0 + mk;
      float av = 0.0f, bv = 0.0f;
      if (m < m_end) {
        const int b = m / Tm, tt = m - (m / Tm) * Tm;
        const size_t step = (size_t)b * T + tt;  // h at t - 1 = tt
        if (i0 + col < H) av = hseq[step * H + i0 + col];
        if (n0 + col < H4) bv = dz[(step + 1) * H4 + n0 + col];
      }
      ha[mk][col] = av;
      za[mk][col] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int mk = 0; mk < kTileK; ++mk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&ha[mk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&za[mk][tx * 4]);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w};
      const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
    __syncthreads();
  }

  float* slab = out + (size_t)blockIdx.z * H * H4;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int i = i0 + ty * 4 + p;
    if (i >= H) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (n < H4) slab[(size_t)i * H4 + n] = acc[p][q];
    }
  }
}

__global__ void lstm_dwh_reduce_kernel(const float* __restrict__ part,
                                       float* dwh, int splits, int size) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= size) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += part[(size_t)z * size + idx];
  dwh[idx] = s;
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

// Number of reduction slices lstm_dwh_launch uses: enough blocks for about
// two waves on the card, each slice at least 256 steps long.  With more
// than one, the caller passes `part` of splits * H * 4H floats.
int lstm_dwh_splits(int B, int T, int H) {
  const int M = B * (T - 1);
  const int tiles = ((4 * H + kTile - 1) / kTile) * ((H + kTile - 1) / kTile);
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int splits = (2 * sms + tiles - 1) / tiles;
  const int max_splits = (M + 255) / 256;
  if (splits > max_splits) splits = max_splits;
  return splits < 1 ? 1 : splits;
}

// dwh (H, 4H) = sum over b and t >= 1 of h[b, t-1]^T dz[b, t].
int lstm_dwh_launch(const float* h, const float* dz, float* dwh, float* part,
                    int B, int T, int H, int splits, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const int M = B * (T - 1);
  int m_per_split = (M + splits - 1) / splits;
  m_per_split = (m_per_split + kTileK - 1) / kTileK * kTileK;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((4 * H + kTile - 1) / kTile, (H + kTile - 1) / kTile,
                  splits);
  lstm_dwh_kernel<<<grid, kThreads, 0, st>>>(h, dz, splits > 1 ? part : dwh,
                                             B, T, H,
                                             m_per_split > 0 ? m_per_split : 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int size = H * 4 * H;
  lstm_dwh_reduce_kernel<<<(size + kThreads - 1) / kThreads, kThreads, 0,
                           st>>>(part, dwh, splits, size);
  return (int)cudaGetLastError();
}

const char* lstm_bptt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
