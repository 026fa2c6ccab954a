// Reverse-time BPTT for the LSTM recurrence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ensemble_svs_with_interactions_tpu/ops/
// pallas_lstm.py:_lstm_bwd_kernel (launched by _recurrence_bwd_pallas), the
// backward of the custom VJP lstm_recurrence_trainable.  The work:
//
//   dz = dxw (B, T, 4H), the gate gradient, in reverse time
//     inputs : xw (B, T, 4H), wh (H, 4H), h and c (B, T, H) from the forward,
//              dy (B, T, H) the gradient into h
//     step t : recompute the gates from xw_t + h_{t-1} W_h;
//              dh = dy_t + dz_{t+1} W_h^T;  dc = dh o (1 - tanh^2 c_t) + dc_next;
//              dz_i = dc g i (1-i), dz_f = dc c_{t-1} f (1-f),
//              dz_g = dc i (1-g^2), dz_o = dh tanh(c_t) o (1-o);  dc_next = dc f
//     H <= 64: lstm_gates_kernel, then lstm_bptt_small_kernel (below);
//     H > 64 : lstm_bptt_kernel
//   lstm_dwh_kernel (+ lstm_dwh_reduce_kernel): dW_h = sum over (b, t) of
//     h_{t-1}^T dz_t, a tiled reduction over the B(T-1) steps with t >= 1
//     (h_{-1} = 0), split over the reduction and summed in a fixed order.
//
// What bounds it.  The BPTT loop is latency bound like the forward (each
// step needs dz_{t+1} of all 4H columns).  Only dh = dy_t + dz_{t+1} W_h^T
// and the cell arithmetic are on that chain: the gate recompute of step t
// needs only h_{t-1}, which the forward stored.  dW_h is a
// (H x B(T-1)) x (B(T-1) x 4H) product, operations bound: on the float32
// SIMT rate (67 TFLOP/s) for a plain kernel, on the TF32 tensor cores'
// rate over 3 (495 / 3 = 165 TFLOP/s of float32-accurate products) for the
// 3xTF32 kernel here, whose design and precision argument stand above it.
//
// Design, H > 64 (lstm_bptt_kernel).  The multi-block forward's layout
// carries over: a block owns the gate columns
// {j, H+j, 2H+j, 3H+j} of U hidden units for a group of batch rows, and
// keeps two slices of W_h in shared memory for the whole sequence: those
// columns (H x 4U, for the recompute) and the rows of its units (U x 4H,
// for dz W_h^T; 32 KB each at H = 512, U = 4).  At each step it writes its
// columns of dz into dxw[:, t], meets the other blocks at a grid barrier
// and reads the whole dxw[:, t] back through L2 (__ldcg) for the next
// step's dh, recomputing its gates inside the loop.  Residency follows the
// forward's plan (lstm_common.cuh).  The H <= 64 design stands above its
// two kernels.
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

// Its one-block branch (nblk == 1) is no longer taken, since H <= 64 has
// its own kernels.  The body stays as measured: small edits to these
// kernels have moved their times by 6-26% on an H100 (PERF.md).
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

// ------------------------------------------------------------------ H <= 64
// Two kernels, one after the other on the caller's stream.
//
// lstm_gates_kernel, the gate pre-pass: for every (b, t) at once, the
// activated gates i, f, g, o = act(xw_t + h_{t-1} W_h) (h_{-1} = 0), a
// (B T x H) x (H x 4H) product with the activations in its epilogue,
// written into dxw itself.  A float32 SIMT tiling: a block takes kGateRows
// rows (b, t) and all 4H columns, keeps W_h (64 KB at H = 64) and the
// rows' h_{t-1} in shared memory, and thread (tx, ty) sums columns
// tx + 64 c (c < 4, conflict-free reads of W_h) for rows ty * 16 + r (r <
// 16, h read as float4 broadcasts): 64 sums of 4 FMAs per 8 shared loads.
// It takes about 65 us of device time at B = 64, T = 256, H = 62 / 64 on
// an H100, six times its bound; loading xw into the sums before the
// product made it slower.
//
// lstm_bptt_small_kernel<HP>, the reverse-time loop, the forward's H <= 64
// layout (lstm_recurrence.cu) turned around: one block per batch row (rows
// never meet: no grid barrier, and blocks past what the card holds
// queue), at a compile-time padded width HP = 32 or 64 (H = 62 runs as
// 64; padded units have zero weights and operands, so their dz is 0, and
// are never written out).  Thread (p, s), 2 HP of them, holds rows 2p and
// 2p + 1 of W_h over quarter s of the 4 HP columns (2 HP weights) in
// registers; dz_{t+1} sits in a double-buffered 4 HP vector in shared
// memory in the padded layout g HP + j, read as float4 broadcasts, each
// value used for both units.  A step's chain is short: 8 FMA chains (4 a
// unit), a reduce-scatter of two __shfl_xor over the quarters (each
// thread keeps the dh of one unit, u = 2p + s / 2), then dc = dh a +
// dc_next and the unit's dz, with the coefficients a, b0, b1 computed from
// the step's operands off the chain.  Thread (p, s) writes dz of gates
// 2 gp and 2 gp + 1 (gp = s % 2) to the other shared buffer and to
// dxw[b, t]; one __syncthreads a step.  The layout with one unit a thread
// over half of the columns (one __shfl_xor, but 32 float4 reads a step
// against 16, the same FMAs) took 0.82 us a step against 0.60 at B = 64,
// T = 256, H = 64 on an H100.  The operands of step t (its 4 gates, c_t, dy_t;
// c_{t-1} is the next step's c) stream in through a kStagesB-deep cp.async
// ring in reverse time, zero wherever nothing is copied, so no load sits
// behind a branch: gate rows (4H floats, 16H bytes) in 16-byte copies, c
// and dy rows (H floats, 248 bytes at H = 62) in 4-byte ones.  The ring
// takes step t's gates from dxw[b, t] several steps before the loop writes
// dz_t there, so the pre-pass needs no scratch.  Padding needs no mask, as
// above.
constexpr int kGateRows = 64;  // pre-pass rows (b, t) per block
constexpr int kGateThreads = 256;
constexpr int kStagesB = 8;    // loop operand ring: steps in flight ahead

__host__ __device__ inline int padded4(int H) { return (H + 3) & ~3; }

size_t gates_smem_bytes(int H) {
  return sizeof(float) * (size_t)padded4(H) * (4 * H + kGateRows);
}

__global__ void __launch_bounds__(kGateThreads)
    lstm_gates_kernel(const float* __restrict__ xw,
                      const float* __restrict__ wh,
                      const float* __restrict__ hseq,
                      float* __restrict__ gates, int M, int T, int H) {
  constexpr int kRowsT = kGateRows / (kGateThreads / 64);  // 16 a thread
  extern __shared__ __align__(16) float smem[];
  const int N = 4 * H;
  const int Kp = padded4(H);
  float* ws = smem;           // [Kp][N]: W_h, rows past H zero
  float* hs = ws + Kp * N;    // [kGateRows][Kp]: h_{t-1} of the rows
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kGateRows;

  // W_h is one contiguous run of H x 4H floats
  const int nw = H * N;
  if ((reinterpret_cast<std::uintptr_t>(wh) & 15u) == 0) {
    for (int i = tid; i < nw / 4; i += kGateThreads)
      reinterpret_cast<float4*>(ws)[i] =
          __ldg(reinterpret_cast<const float4*>(wh) + i);
  } else {
    for (int i = tid; i < nw; i += kGateThreads) ws[i] = __ldg(wh + i);
  }
  for (int i = nw + tid; i < Kp * N; i += kGateThreads) ws[i] = 0.0f;
  // row m = b T + t takes h row m - 1, or 0 at t = 0
  for (int i = tid; i < kGateRows * Kp; i += kGateThreads) {
    const int r = i / Kp, k = i - r * Kp;
    const int m = m0 + r;
    const bool in = k < H && m < M && m % T != 0;
    hs[i] = in ? __ldg(hseq + (size_t)(m - 1) * H + k) : 0.0f;
  }
  __syncthreads();

  const int tx = tid & 63, ty = tid >> 6;
  int col[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) col[c] = tx + 64 * c < N ? tx + 64 * c : 0;
  float acc[kRowsT][4];
#pragma unroll
  for (int r = 0; r < kRowsT; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  const float* hrow = hs + ty * kRowsT * Kp;
  for (int k = 0; k < Kp; k += 4) {
    float w[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) w[kk][c] = ws[(k + kk) * N + col[c]];
#pragma unroll
    for (int r = 0; r < kRowsT; ++r) {
      const float4 hv = *reinterpret_cast<const float4*>(hrow + r * Kp + k);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float& a = acc[r][c];
        a = fmaf(hv.x, w[0][c], a);
        a = fmaf(hv.y, w[1][c], a);
        a = fmaf(hv.z, w[2][c], a);
        a = fmaf(hv.w, w[3][c], a);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsT; ++r) {
    const int m = m0 + ty * kRowsT + r;
    if (m >= M) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = tx + 64 * c;
      if (n >= N) break;
      const size_t o = (size_t)m * N + n;
      const float z = acc[r][c] + __ldg(xw + o);
      gates[o] = n / H == 2 ? tanhf(z) : sigmoid_f32(z);
    }
  }
}

// Thread tid is (unit pair p, quarter s) = (tid / 4, tid % 4): it holds
// W_h[2p + jj] (jj < 2) at the padded columns 4 (4q + s) + e, q < HP / 4.
// Block b runs batch row b.
template <int HP>
__global__ void __launch_bounds__(2 * HP)
    lstm_bptt_small_kernel(const float* __restrict__ wh,
                           const float* __restrict__ cseq,
                           const float* __restrict__ dy, float* dxw, int T,
                           int H) {
  constexpr int kThreadsS = 2 * HP;  // HP / 2 unit pairs x 4 quarters
  constexpr int kChunks = HP / 4;  // float4 chunks of dz a quarter
  constexpr int kC = 4 * HP, kDy = 5 * HP, kSlot = 6 * HP;  // gates | c | dy
  __shared__ __align__(16) float dzs[2][4 * HP];  // dz_{t+1} | dz_t
  __shared__ __align__(16) float ring[kStagesB][kSlot];

  const int tid = threadIdx.x;
  const int s = tid & 3, p = tid >> 2;
  // cell role: unit u, gates 2 gp and 2 gp + 1
  const int u = 2 * p + (s >> 1), gp = s & 1;
  const int H4 = 4 * H;
  const size_t base = (size_t)blockIdx.x * T;
  const bool unit = u < H;

  // padded column 16q + 4s + e is gate 16q / HP, unit 16q % HP + 4s + e
  float w[2][kChunks][4];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int q = 0; q < kChunks; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int uu = 2 * p + jj;
        const int j = (16 * q) % HP + 4 * s + e;
        w[jj][q][e] = (uu < H && j < H)
                          ? wh[(size_t)uu * H4 + (16 * q / HP) * H + j]
                          : 0.0f;
      }
  for (int i = tid; i < 2 * 4 * HP; i += kThreadsS) (&dzs[0][0])[i] = 0.0f;
  // the ring starts zeroed: gate columns past 4H and units past H are never
  // copied, so they stay 0, and a padded unit reads its gates there
  for (int i = tid; i < kStagesB * kSlot; i += kThreadsS)
    (&ring[0][0])[i] = 0.0f;
  int gcol[4];  // this unit's gate columns in a ring slot
#pragma unroll
  for (int g = 0; g < 4; ++g) gcol[g] = unit ? g * H + u : H4;
  __syncthreads();

  // copy roles: thread tid < H moves gate columns 4 tid .. 4 tid + 3 and
  // c[tid]; thread HP + j, j < H, moves dy[j]
  const bool gcopy = tid < H;
  const bool dcopy = tid >= HP && tid - HP < H;
  const float* gsrc = dxw + base * H4 + 4 * (gcopy ? tid : 0);
  const float* csrc = cseq + base * H + (gcopy ? tid : 0);
  const float* dsrc = dy + base * H + (dcopy ? tid - HP : 0);
  auto fetch = [&](int k) {  // step t = T - 1 - k; one group a step
    if (k < T) {
      const size_t t = T - 1 - k;
      float* slot = ring[k % kStagesB];
      if (gcopy) {
        cp_async16(slot + 4 * tid, gsrc + t * H4);
        cp_async4(slot + kC + tid, csrc + t * H, 4);
      }
      if (dcopy) cp_async4(slot + kDy + tid - HP, dsrc + t * H, 4);
    }
    cp_async_commit();
  };
  for (int k = 0; k < kStagesB - 1; ++k) fetch(k);

  float* out = unit ? dxw + base * H4 + 2 * gp * H + u : nullptr;
  float dc_next = 0.0f;
  cp_async_wait<kStagesB - 3>();  // steps 0 and 1 landed
  __syncthreads();

  for (int k = 0; k < T; ++k) {
    const int cur = k & 1;
    // step t's operands, and c_{t-1} from the next step's slot
    const float* sl = ring[k % kStagesB];
    const float gi = sl[gcol[0]], gf = sl[gcol[1]], gg = sl[gcol[2]],
                go = sl[gcol[3]];
    const float c_t = sl[kC + u], dy_t = sl[kDy + u];
    const float c_p = ring[(k + 1) % kStagesB][kC + u];
    // off the chain: dc = dh a + dc_next; this thread's dz are d0 = dc b0
    // and d1 = (gp ? dh : dc) b1
    const float tc = tanh_fast(c_t);
    const float a = go * (1.0f - tc * tc);
    const float b0 = gp == 0 ? gg * gi * (1.0f - gi) : gi * (1.0f - gg * gg);
    const float b1 = gp == 0 ? (k + 1 < T ? c_p : 0.0f) * gf * (1.0f - gf)
                             : tc * go * (1.0f - go);

    float acc0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float acc1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(&dzs[cur][4 * (4 * q + s)]);
      float& p0 = acc0[q & 3];
      float& p1 = acc1[q & 3];
      p0 = fmaf(v.x, w[0][q][0], p0);
      p1 = fmaf(v.x, w[1][q][0], p1);
      p0 = fmaf(v.y, w[0][q][1], p0);
      p1 = fmaf(v.y, w[1][q][1], p1);
      p0 = fmaf(v.z, w[0][q][2], p0);
      p1 = fmaf(v.z, w[1][q][2], p1);
      p0 = fmaf(v.w, w[0][q][3], p0);
      p1 = fmaf(v.w, w[1][q][3], p1);
    }
    const float h0 = (acc0[0] + acc0[1]) + (acc0[2] + acc0[3]);
    const float h1 = (acc1[0] + acc1[1]) + (acc1[2] + acc1[3]);
    // reduce-scatter over the 4 quarters: keep the partial of own unit,
    // pass the other unit's to the quarter s ^ 2, then add quarter s ^ 1's
    float dh = (s >> 1) ? h1 : h0;
    dh += __shfl_xor_sync(0xffffffffu, (s >> 1) ? h0 : h1, 2);
    dh += __shfl_xor_sync(0xffffffffu, dh, 1);
    dh += dy_t;
    const float dc = fmaf(dh, a, dc_next);
    const float d0 = dc * b0;
    const float d1 = (gp == 0 ? dc : dh) * b1;
    dc_next = dc * gf;
    dzs[cur ^ 1][2 * gp * HP + u] = d0;
    dzs[cur ^ 1][(2 * gp + 1) * HP + u] = d1;
    if (out != nullptr) {
      const size_t t = T - 1 - k;
      out[t * H4] = d0;
      out[t * H4 + H] = d1;
    }
    fetch(k + kStagesB - 1);  // into the slot step k - 1 read
    cp_async_wait<kStagesB - 3>();
    __syncthreads();
  }
}

cudaError_t launch_gates(const float* xw, const float* wh, const float* h,
                         float* gates, int B, int T, int H, cudaStream_t st) {
  const size_t smem = gates_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_gates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int M = B * T;
  lstm_gates_kernel<<<(M + kGateRows - 1) / kGateRows, kGateThreads, smem,
                      st>>>(xw, wh, h, gates, M, T, H);
  return cudaGetLastError();
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
// `counters` must hold lstm_bptt_counters(B, H) zeroed uint32 values.  At
// H <= kSmallH the gate pre-pass writes dxw first and the loop reads it
// back in 16-byte copies, so dxw must be 16-byte aligned (any tensor that
// starts at a row); the inputs may start anywhere.
int lstm_bptt_launch(const float* xw, const float* wh, const float* h,
                     const float* c, const float* dy, float* dxw,
                     unsigned int* counters, int B, int T, int H,
                     void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (H <= kSmallH) {
    if (!aligned16(dxw)) return (int)cudaErrorMisalignedAddress;
    cudaError_t err = launch_gates(xw, wh, h, dxw, B, T, H, st);
    if (err != cudaSuccess) return (int)err;
    const int hp = H <= 32 ? 32 : 64;
    auto* kernel = hp == 32 ? lstm_bptt_small_kernel<32>
                            : lstm_bptt_small_kernel<64>;
    kernel<<<B, 2 * hp, 0, st>>>(wh, c, dy, dxw, T, H);
    return (int)cudaGetLastError();
  }
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
  int U = q.p.U, S = q.p.S, pitch = q.p.pitch, S2 = q.S2, pitch2 = q.pitch2,
      gpb = r.gpb;
  void* args[] = {(void*)&xw,     (void*)&wh, (void*)&h,      (void*)&c,
                  (void*)&dy,     (void*)&dxw, (void*)&counters, (void*)&B,
                  (void*)&T,      (void*)&H,  (void*)&U,      (void*)&S,
                  (void*)&pitch,  (void*)&S2, (void*)&pitch2, (void*)&gpb};
  err = cudaLaunchCooperativeKernel((const void*)lstm_bptt_kernel, grid,
                                    dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Barrier counters lstm_bptt_launch needs: none at H <= kSmallH, else one
// per group of kMaxRows rows.
int lstm_bptt_counters(int B, int H) {
  return H <= kSmallH ? 0 : (B + kMaxRows - 1) / kMaxRows;
}

// The gate pre-pass of lstm_bptt_launch alone (H <= kSmallH): gates
// (B, T, 4H) = act(xw + h_{t-1} W_h), i, f, o through the sigmoid and g
// through tanh.
int lstm_gates_launch(const float* xw, const float* wh, const float* h,
                      float* gates, int B, int T, int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > kSmallH)
    return (int)cudaErrorInvalidValue;
  return (int)launch_gates(xw, wh, h, gates, B, T, H, (cudaStream_t)stream);
}

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
