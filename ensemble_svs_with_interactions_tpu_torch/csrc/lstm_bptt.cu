// Reverse-time BPTT for the LSTM recurrence, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ensemble_svs_with_interactions_tpu/ops/
// pallas_lstm.py:_lstm_bwd_kernel (launched by _recurrence_bwd_pallas), the
// backward of the custom VJP lstm_recurrence_trainable.  The work:
//
//   dz = dxw (B, T, 4H), the gate gradient, in reverse time
//     inputs : xw (B, T, 4H), wh (H, 4H), h and c (B, T, H) from the forward,
//              dy (B, T, H) the gradient into h
//     gates  : i, f, g, o = act(xw_t + h_{t-1} W_h) for every step at once,
//              a parallel pre-pass written into dxw;
//     step t : dh = dy_t + dz_{t+1} W_h^T;  dc = dh o (1 - tanh^2 c_t) + dc_next;
//              dz_i = dc g i (1-i), dz_f = dc c_{t-1} f (1-f),
//              dz_g = dc i (1-g^2), dz_o = dh tanh(c_t) o (1-o);  dc_next = dc f
//     H <= 64 : lstm_gates_kernel, then lstm_bptt_small_kernel (below);
//     64 < H <= kMaxGroupH (512): lstm_gates_mma_kernel, then
//               lstm_bptt_group_kernel (the H > 64 section below);
//     kMaxGroupH < H <= kMaxBpttH (1024): lstm_gates_mma_kernel, then
//               lstm_bptt_mma_kernel (the 512 < H <= 1024 section);
//     wider: refused (a warp's part of W_h would outgrow its registers)
//   lstm_dwh_kernel (+ lstm_dwh_reduce_kernel): dW_h = sum over (b, t) of
//     h_{t-1}^T dz_t, a tiled reduction over the B(T-1) steps with t >= 1
//     (h_{-1} = 0), split over the reduction and summed in a fixed order.
//
// What bounds it.  The BPTT loop is latency bound like the forward (each
// step needs dz_{t+1} of all 4H columns).  Only dh = dy_t + dz_{t+1} W_h^T
// and the cell arithmetic are on that chain: the gates of step t need only
// h_{t-1}, which the forward stored, so a pre-pass computes them all in
// parallel, a (BT x H) x (H x 4H) product.  That product and dW_h, a
// (H x B(T-1)) x (B(T-1) x 4H) product, are operations bound: on the
// float32 SIMT rate (67 TFLOP/s) for a plain kernel, on the TF32 tensor
// cores' rate over 3 (495 / 3 = 165 TFLOP/s of float32-accurate products)
// for the 3xTF32 kernels here, whose design and precision argument stand
// above lstm_dwh_kernel.  The designs of the loops stand above their
// kernels.
// dW_h is a second kernel, not an accumulation inside the loop: the loop's
// blocks split the batch, so an in-loop sum would need a cross-block pass
// anyway, and a separate tiled product keeps work off the sequential path.
// Padding needs no mask: the layer zeroes its outputs at padded steps, so dy
// is 0 there, and padding is a suffix, so dh and dc enter the valid steps
// as 0.

#include <atomic>

#include "lstm_common.cuh"

namespace {

using namespace lstm;

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

// ------------------------------------------------------------------- H > 64
// Two kernels, one after the other on the caller's stream, at
// 64 < H <= kMaxGroupH.
//
// lstm_gates_mma_kernel<kVec>, the gate pre-pass: act(xw + h_{t-1} W_h) for
// every row m = (b, t) at once, a (BT x H) x (H x 4H) product whose
// epilogue adds xw and applies the activations, written into dxw.  It is
// lstm_dwh_kernel's 3xTF32 machinery (split_tf32, mma_tf32, each k8
// partial added to an f32 sum; the same precision argument) on a 64 x 128
// block tile of (rows, gate columns), 8 warps as 2 x 4 of 32 x 32, the
// reduction over H in k-tiles of 16 through a 3-stage zero-filled cp.async
// ring, two blocks per SM.  The A tile holds h rows m - 1 with the
// reduction contiguous (a pitch of 20 floats: a warp's fragment loads hit
// 32 distinct banks), zero on the rows with t = 0 (h_{-1} = 0); the B tile
// holds rows of W_h, as lstm_dwh_kernel's B tile holds rows of dz.
// 16-byte copies where H % 4 == 0 and h and W_h are 16-byte aligned,
// 4-byte copies otherwise.  3xTF32 rather than a float32 SIMT tiling: 165
// TFLOP/s of float32-accurate products against 67, with the ring and the
// precision already proven on dW_h.  The reduction is short (H), so a
// block's start and epilogue weigh: 128 x 128 tiles at one block per SM
// took 0.94-0.95 ms at B = 64, T = 256, H = 512 on an H100, these
// 0.72-0.73 in the same call (tools/bench_bptt_builds.py).
//
// lstm_bptt_group_kernel<NC>, the reverse-time loop, a cooperative launch
// whose grid splits the units and the batch: block (x, y) owns kUnitsG = 16
// units (all four gate columns of each) for the groups of kRowsG = 16
// batch rows of grid row y.  The blocks of a grid row exchange only their
// rows' dz and meet at their own barrier (counters[y]).  The rows of W_h
// of the block's units (16 x 4H, 128 KB at H = 512) sit in registers for
// the whole sequence: thread (warp w, lane (ug, kl)), ug < 4, kl < 8, holds
// units j0 + 4 ug .. j0 + 4 ug + 3 at the float4 columns ks + 64 c (k slice
// ks = 8 w + kl, c < NC, 4H <= 256 NC): 16 NC floats, 128 at NC = 8.  Each
// step, for each of the block's groups:
//   - each warp copies the dz_{t+1} columns its own lanes read (8 float4
//     columns of every chunk c, 16 rows) from dxw[:, t + 1] into shared
//     memory with cp.async.cg, which reads through L2 and so sees the
//     other blocks' writes after the barrier: one commit group per chunk,
//     kAheadG = 3 chunks ahead of the one being multiplied, and a warp
//     waits only for its own copies (__syncwarp).  Issuing all NC chunks
//     at once stalled the warps on the copies' issue (per-phase clocks of
//     one block: 2,800-5,500 cycles a step of 13,800 at H = 512) and took
//     1.66-1.72 ms a loop at B = 64, T = 256 against 1.58-1.59 in the
//     same call on an H100;
//   - the cell's operands of step t (its 4 gates from dxw[b, t] through
//     __ldcg, as this launch overwrites them with dz_t; c_t, c_{t-1}, dy_t)
//     are loaded before the product and used after it;
//   - dh (16 rows x 16 units) = dz_{t+1} W_rows^T in two passes of 8 rows:
//     each float4 of dz (one 128-byte broadcast read for the warp's 4 unit
//     groups) meets the thread's 4 units, 16 FMAs a shared load, into 32
//     sums; a reduce-scatter over the warp's 8 k-slice lanes (16 + 8 + 4
//     __shfl_xor) leaves lane kl the sums of row kl, and the 8 warps'
//     partials meet in shared memory, summed in warp order by thread
//     (row, unit) = (tid / 16, tid % 16), one __syncthreads a group.  The
//     same product as 3xTF32 mma.sync, with the same 128 registers of W_h
//     as fragments, took 2.19-2.23 ms a loop against 1.74-1.76 at H = 512
//     (0.94-0.95 against 1.17-1.21 at H = 256) in one call on an H100, so
//     it stays SIMT;
//   - that thread does the cell arithmetic and writes its dz_t into dxw.
// Then the grid row's barrier.  When the card cannot hold every block at
// once, a block takes gpb groups in turn inside each step (plan_groups;
// dc_next of each group in shared memory); a launch that cannot fit
// raises.  Units past H have zero weights and are not written; rows past B
// are zero-filled by the copy and not written; c, dy and the gates are
// read as floats, so rows of any length (H = 98: 392 bytes) and inputs at
// any alignment are taken.  dxw, which the loop copies in 16-byte pieces,
// is the caller's fresh allocation.  Padding needs no mask, as above.
constexpr int kGBM = 64, kGBN = 128, kGBK = 16;  // pre-pass block tile
constexpr int kStagesG = 3;
constexpr int kPitchGA = kGBK + 4;  // == 20 (mod 32): conflict-free A frags
constexpr int kPitchGB = kGBN + 8;
constexpr int kRowsG = 16;          // batch rows per group
constexpr int kSlicesG = 64;        // float4 column c is in k slice c % 64
constexpr int kAheadG = 3;          // dz chunks in flight ahead of the one
                                    // being multiplied
constexpr int kWarpsG = kThreads / 32;

constexpr size_t gates_mma_smem_bytes() {
  return sizeof(float) * kStagesG *
         ((size_t)kGBM * kPitchGA + (size_t)kGBK * kPitchGB);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreadsD, 2)
    lstm_gates_mma_kernel(const float* __restrict__ xw,
                          const float* __restrict__ wh,
                          const float* __restrict__ hseq,
                          float* __restrict__ gates, int M, int T, int H) {
  constexpr int V = kVec ? 4 : 1;           // floats a copy
  constexpr int ACOLS = kGBK / V;           // copies per A row
  constexpr int AROWS = kThreadsD / ACOLS;  // A rows per pass
  constexpr int NA = kGBM / AROWS;
  constexpr int BCOLS = kGBN / V;
  constexpr int BROWS = kThreadsD / BCOLS;
  constexpr int NB = kGBK / BROWS;
  constexpr int MT = kGBM / 32;  // m16 tiles per warp
  constexpr int NQ = kGBN / 32;  // n8 tiles per warp
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                               // [stage][kGBM][kPitchGA]
  float* Bs = smem + kStagesG * kGBM * kPitchGA;  // [stage][kGBK][kPitchGB]
  const int N = 4 * H;
  const int m0 = blockIdx.y * kGBM, n0 = blockIdx.x * kGBN;
  const int ktiles = (H + kGBK - 1) / kGBK;
  const int tid = threadIdx.x;

  // row m of the product is h row m - 1, none (zero) where t = 0
  const int ar = tid / ACOLS, ac = V * (tid % ACOLS);
  const float* arow[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int m = m0 + ar + i * AROWS;
    arow[i] = m < M && m % T != 0 ? hseq + (size_t)(m - 1) * H : nullptr;
  }
  const int br = tid / BCOLS, bc = V * (tid % BCOLS);

  auto load_tile = [&](int stage, int k0) {
    float* ad = As + stage * kGBM * kPitchGA;
    float* bd = Bs + stage * kGBK * kPitchGB;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int k = k0 + ac;
      const bool in = arow[i] != nullptr && k < H;
      float* dst = ad + (ar + i * AROWS) * kPitchGA + ac;
      const float* src = in ? arow[i] + k : hseq;
      if (kVec) {
        cp_async16(dst, src, in ? 16 : 0);
      } else {
        cp_async4(dst, src, in ? 4 : 0);
      }
    }
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      const int k = k0 + br + i * BROWS, n = n0 + bc;
      const bool in = k < H && n < N;
      float* dst = bd + (br + i * BROWS) * kPitchGB + bc;
      const float* src = in ? wh + (size_t)k * N + n : wh;
      if (kVec) {
        cp_async16(dst, src, in ? 16 : 0);
      } else {
        cp_async4(dst, src, in ? 4 : 0);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * (kGBM / 2), wn = (warp & 3) * (kGBN / 4);
  const int gid = lane >> 2, tig = lane & 3;
  float acc[MT][NQ][4];
#pragma unroll
  for (int p = 0; p < MT; ++p)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][q][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < kStagesG - 1; ++st) {
    if (st < ktiles) load_tile(st, st * kGBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStagesG - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    if (kt + kStagesG - 1 < ktiles)
      load_tile((kt + kStagesG - 1) % kStagesG, (kt + kStagesG - 1) * kGBK);
    cp_async_commit();
    const float* as =
        As + (kt % kStagesG) * kGBM * kPitchGA + (wm + gid) * kPitchGA + tig;
    const float* bs =
        Bs + (kt % kStagesG) * kGBK * kPitchGB + tig * kPitchGB + wn + gid;
#pragma unroll
    for (int kk = 0; kk < kGBK; kk += 8) {
      unsigned bh[NQ][2], bl[NQ][2];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        split_tf32(bs[kk * kPitchGB + 8 * q], bh[q][0], bl[q][0]);
        split_tf32(bs[(kk + 4) * kPitchGB + 8 * q], bh[q][1], bl[q][1]);
      }
#pragma unroll
      for (int p = 0; p < MT; ++p) {
        const float* a = as + 16 * p * kPitchGA + kk;
        unsigned ah[4], al[4];
        split_tf32(a[0], ah[0], al[0]);                 // (gid, tig)
        split_tf32(a[8 * kPitchGA], ah[1], al[1]);      // (gid + 8, tig)
        split_tf32(a[4], ah[2], al[2]);                 // (gid, tig + 4)
        split_tf32(a[8 * kPitchGA + 4], ah[3], al[3]);  // (gid + 8, tig + 4)
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

#pragma unroll
  for (int p = 0; p < MT; ++p)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int m = m0 + wm + 16 * p + gid + 8 * e2;
      if (m >= M) continue;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int n = n0 + wn + 8 * q + 2 * tig;  // even, and N is even
        if (n >= N) continue;
        const size_t o = (size_t)m * N + n;
        float z[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          z[e] = acc[p][q][2 * e2 + e] + __ldg(xw + o + e);
          z[e] = (n + e) / H == 2 ? tanhf(z[e]) : sigmoid_f32(z[e]);
        }
        *reinterpret_cast<float2*>(gates + o) = make_float2(z[0], z[1]);
      }
    }
}

template <bool kVec>
cudaError_t launch_gates_mma(const float* xw, const float* wh, const float* h,
                             float* gates, int M, int T, int H,
                             cudaStream_t st) {
  constexpr size_t smem = gates_mma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      lstm_gates_mma_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((4 * H + kGBN - 1) / kGBN, (M + kGBM - 1) / kGBM);
  lstm_gates_mma_kernel<kVec><<<grid, kThreadsD, smem, st>>>(xw, wh, h, gates,
                                                             M, T, H);
  return cudaGetLastError();
}

// The gate pre-pass into gates (B, T, 4H): lstm_gates_kernel at H <=
// kSmallH, lstm_gates_mma_kernel above (which stores float pairs, so gates
// must be 8-byte aligned there).
cudaError_t launch_gates(const float* xw, const float* wh, const float* h,
                         float* gates, int B, int T, int H, cudaStream_t st) {
  const int M = B * T;
  if (H > kSmallH) {
    if ((reinterpret_cast<std::uintptr_t>(gates) & 7u) != 0)
      return cudaErrorMisalignedAddress;
    return H % 4 == 0 && aligned16(h) && aligned16(wh)
               ? launch_gates_mma<true>(xw, wh, h, gates, M, T, H, st)
               : launch_gates_mma<false>(xw, wh, h, gates, M, T, H, st);
  }
  const size_t smem = gates_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_gates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  lstm_gates_kernel<<<(M + kGateRows - 1) / kGateRows, kGateThreads, smem,
                      st>>>(xw, wh, h, gates, M, T, H);
  return cudaGetLastError();
}

size_t group_smem_bytes(int nc, int gpb) {
  return sizeof(float) * ((size_t)kRowsG * 4 * kSlicesG * nc +
                          2 * kWarpsG * kRowsG * kUnitsG +
                          (size_t)gpb * kThreads);
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bptt_group_kernel(const float* __restrict__ wh,
                           const float* __restrict__ cseq,
                           const float* __restrict__ dy, float* dxw,
                           unsigned int* counters, int B, int T, int H,
                           int gpb) {
  constexpr int P = 4 * kSlicesG * NC;  // dz row pitch in floats, >= 4H
  constexpr int RS = kRowsG * kUnitsG;  // dh sums of a group
  extern __shared__ __align__(16) float smem[];
  float* dzs = smem;                    // [kRowsG][P]: dz_{t+1} of a group
  float* red = dzs + kRowsG * P;        // [2][kWarpsG][RS]: warps' dh sums
  float* dcs = red + 2 * kWarpsG * RS;  // [gpb][kThreads]: dc_next

  const int H4 = 4 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ug = lane >> 3, kl = lane & 7, ks = 8 * warp + kl;
  const int j0 = blockIdx.x * kUnitsG;
  const unsigned int nblk = gridDim.x;
  const int g0 = blockIdx.y * gpb;
  const int ngroups = min(gpb, (B + kRowsG - 1) / kRowsG - g0);

  float4 w[4][NC];  // W_h[j0 + 4 ug + uu][4 (ks + 64 c) + e], zero past H, 4H
#pragma unroll
  for (int uu = 0; uu < 4; ++uu)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int jr = j0 + 4 * ug + uu, n = 4 * (ks + kSlicesG * c);
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = jr < H && n < H4 ? __ldg(wh + (size_t)jr * H4 + n + i) : 0.0f;
      w[uu][c] = make_float4(e[0], e[1], e[2], e[3]);
    }
  for (int g = 0; g < ngroups; ++g) dcs[g * kThreads + tid] = 0.0f;
  // cell role: row r of the group, unit j
  const int r = tid / kUnitsG, j = j0 + tid % kUnitsG;
  int buf = 0;

  for (int t = T - 1; t >= 0; --t) {
    const bool next = t + 1 < T;  // dz_T = 0
    for (int grp = 0; grp < ngroups; ++grp) {
      const int gb = (g0 + grp) * kRowsG;
      const int grows = min(kRowsG, B - gb);
      auto copy_chunk = [&](int c) {  // one commit group, empty past NC
        if (c < NC) {
          const int n = 4 * (ks + kSlicesG * c);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int rr = ug + 4 * q;
            const bool in = rr < grows && n < H4;
            cp_async16(
                dzs + rr * P + n,
                in ? dxw + ((size_t)(gb + rr) * T + t + 1) * H4 + n : dxw,
                in ? 16 : 0);
          }
        }
        cp_async_commit();
      };
      if (next) {
#pragma unroll
        for (int c = 0; c < kAheadG; ++c) copy_chunk(c);
      }
      const bool cell = r < grows && j < H;
      const size_t row = (size_t)(gb + (cell ? r : 0)) * T + t;
      float gi = 0.0f, gf = 0.0f, gg = 0.0f, go = 0.0f;
      float c_t = 0.0f, c_p = 0.0f, dy_t = 0.0f;
      if (cell) {
        const float* gz = dxw + row * H4 + j;
        gi = __ldcg(gz);
        gf = __ldcg(gz + H);
        gg = __ldcg(gz + 2 * H);
        go = __ldcg(gz + 3 * H);
        c_t = __ldg(cseq + row * H + j);
        c_p = t > 0 ? __ldg(cseq + (row - 1) * H + j) : 0.0f;
        dy_t = __ldg(dy + row * H + j);
      }

      float* rb = red + buf * kWarpsG * RS;
#pragma unroll 1
      for (int pass = 0; pass < 2; ++pass) {
        float v[32];  // v[4 rr + uu]: row 8 pass + rr, unit j0 + 4 ug + uu
#pragma unroll
        for (int i = 0; i < 32; ++i) v[i] = 0.0f;
        if (next) {
          const float* col = dzs + 8 * pass * P + 4 * ks;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if (pass == 0) {
              copy_chunk(c + kAheadG);
              cp_async_wait<kAheadG>();  // this lane's chunk c landed
              __syncwarp();              // and the warp's
            }
#pragma unroll
            for (int rr = 0; rr < 8; ++rr) {
              const float4 d = *reinterpret_cast<const float4*>(
                  col + rr * P + 4 * kSlicesG * c);
#pragma unroll
              for (int uu = 0; uu < 4; ++uu) {
                float& a = v[4 * rr + uu];
                a = fmaf(d.x, w[uu][c].x, a);
                a = fmaf(d.y, w[uu][c].y, a);
                a = fmaf(d.z, w[uu][c].z, a);
                a = fmaf(d.w, w[uu][c].w, a);
              }
            }
          }
        }
        reduce_half<16>(v, 4, kl & 4);
        reduce_half<8>(v, 2, kl & 2);
        reduce_half<4>(v, 1, kl & 1);
        *reinterpret_cast<float4*>(rb + warp * RS + (8 * pass + kl) * kUnitsG +
                                   4 * ug) = make_float4(v[0], v[1], v[2],
                                                         v[3]);
      }
      __syncthreads();

      float dh = dy_t;
#pragma unroll
      for (int k = 0; k < kWarpsG; ++k) dh += rb[k * RS + tid];
      if (cell) {
        float& dc_next = dcs[grp * kThreads + tid];
        const float tc = tanhf(c_t);
        const float dc = dh * go * (1.0f - tc * tc) + dc_next;
        float* dz = dxw + row * H4 + j;
        dz[0] = dc * gg * gi * (1.0f - gi);
        dz[H] = dc * c_p * gf * (1.0f - gf);
        dz[2 * H] = dc * gi * (1.0f - gg * gg);
        dz[3 * H] = dh * tc * go * (1.0f - go);
        dc_next = dc * gf;
      }
      buf ^= 1;
    }
    if (t > 0) grid_barrier(counters + blockIdx.y, nblk * (unsigned)(T - t));
  }
}

template <int NC>
cudaError_t launch_bptt_group(const float* wh, const float* c,
                              const float* dy, float* dxw,
                              unsigned int* counters, int B, int T, int H,
                              cudaStream_t st) {
  const auto kernel = lstm_bptt_group_kernel<NC>;
  const int nblk = (H + kUnitsG - 1) / kUnitsG;
  GroupPlan g;
  cudaError_t err = plan_groups(
      kernel, (B + kRowsG - 1) / kRowsG, nblk,
      [](int gpb) { return group_smem_bytes(NC, gpb); }, &g);
  if (err != cudaSuccess) return err;
  int gpb = g.gpb;
  void* args[] = {(void*)&wh,       (void*)&c, (void*)&dy, (void*)&dxw,
                  (void*)&counters, (void*)&B, (void*)&T,  (void*)&H,
                  (void*)&gpb};
  err = cudaLaunchCooperativeKernel((const void*)kernel,
                                    dim3(nblk, g.grid_rows), dim3(kThreads),
                                    args, g.smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ------------------------------------------------------ 512 < H <= 1024
// The gate pre-pass is lstm_gates_mma_kernel, as above.  The reverse loop,
// lstm_bptt_mma_kernel<NK>, is a cooperative launch of clusters of two
// blocks (128 blocks at H = 1024, one an SM).  Cluster c owns kUnitsB = 16
// units, j0 = 16 c .. 16 c + 15, for every batch row; a reverse step's work
// in it is one (B, 4H) x (4H, 16) product, dz_{t+1} times its 16 rows of
// W_h transposed, split by k between its two blocks: rank 0 takes the gate
// columns [0, kh), rank 1 [kh, 4H) (kh = 2H rounded up to a k16 block).
// Each block multiplies all batch rows of the step at once on the tensor
// cores, its (B, kh) x (kh, 16) half:
//   - 3xTF32 mma.sync.m16n8k8 (split_tf32, mma_tf32 and the precision
//     argument above lstm_dwh_kernel: each k8 partial is summed from zero,
//     then added to an f32 sum).  Plain TF32 keeps about three decimal
//     digits of each product, which 1e-4 over hundreds of reverse steps
//     does not allow;
//   - split-K over the 8 warps: warp w sums over the columns [16 NK w,
//     16 NK (w + 1)) of the block's half (NK = kNkB = 16 k16 blocks, the
//     widest half's 2048 columns over 8 warps; at a narrower H the columns
//     past the half have zero weights and zero-filled copies, so one
//     instantiation serves every width) and keeps its part of the 16 rows,
//     16 NK x 16 floats,
//     as B fragments of two n8 tiles in registers for the whole sequence
//     (128 a thread at H = 1024), split into hi and lo where they are used
//     (an empty asm over them each m16 tile keeps the compiler from
//     hoisting the splits out of the loops, which would need twice the
//     registers).  wgmma, Hopper's full-rate product, reads B from shared
//     memory, where the hi and lo parts of a block's slice (256 KiB at H =
//     1024) do not fit; it was not tried;
//   - inside each k16 block the k order is permuted, the same way for both
//     operands: lane (g, t) takes k = 4 t .. 4 t + 3, two a k8 step, so
//     its A fragment of rows g and g + 8 is two float4, and each A
//     fragment (split once) feeds both n8 tiles;
//   - the block's half of dz_{t+1} (written by every cluster at step t + 1)
//     streams from dxw through a kRingB-stage cp.async.cg ring per warp,
//     one chunk (16 rows x 16 k) a stage, kRingB - 1 chunks ahead of the
//     one being multiplied; .cg reads through L2, so it sees the other
//     blocks' writes after the barrier.  Each lane copies the two float4
//     of its own A fragment; a warp sync after each wait lets the lanes
//     read each other's rows (the path below) and frees the slot the warp
//     read last;
//   - a launch of at most kSimtRowsB = 8 rows (the 4 crops of a small train
//     step) skips the tensor cores, whose m16 tile would be mostly
//     padding: each lane copies its row's k's of the whole step at once
//     (one round trip to L2) and multiplies the same W_h fragments, its 4
//     k's of units g and 8 + g, by them in float32 FMAs; the units' 4
//     lanes meet by shuffles;
//   - the batch runs in tiles of kRowTileB = 64 rows (4 m16 tiles, rows
//     past B zero-filled by the copy), each tile's m16 tiles in turn, so
//     any B runs in the same registers.  A launch takes up to
//     kLaunchRowsB = 512 rows (their dc carry sits in shared memory); more
//     rows take more launches, one after another on the stream, each with
//     its own barrier counter.  No batch is refused for residency;
//   - a tile's 8 warps leave their partial sums of dh in shared memory
//     (two buffers, alternating by tile).  After one __syncthreads, thread
//     (row, unit) adds the 8 partials in warp order for one of the block's
//     8 cell units (rank 0 updates units j0 .. j0 + 7, rank 1 the other 8)
//     and for the same unit of the partner's, which it stores into the
//     partner's shared memory (distributed shared memory, one cluster
//     barrier a tile).  dh = dy_t + rank 0's half + rank 1's half, in that
//     order in both blocks: no atomics, so two launches agree bitwise.
//     The cell operands (the unit's 4 gates from dxw[b, t] through __ldcg,
//     as this launch overwrites them with dz_t; c_t, c_{t-1}, dy_t) are
//     loaded a tile ahead, behind the barrier and the product.  The thread
//     does the cell arithmetic, keeps dc_next in shared memory and writes
//     dz_t into dxw.
// Then one grid barrier a step (grid_barrier_release).  Units past H have
// zero weights and are not written; rows past B are not read.  c, dy and
// the gates are read as floats at any alignment; dxw, read in 16-byte
// pieces, is the caller's 16-byte aligned allocation, and its rows (4H
// floats) and both halves of them keep that.  Padding needs no mask, as
// above.
//
// What bounds it, timed on an H100 (tools/bench_bptt_builds.py, builds
// that leave one part out, B = 64, T = 128, H = 1024: 24.8 us a step):
// the products about 10.4 us, the copies of dz 7.4, the rest (the reads
// of the A fragments from shared memory, the cell update with its
// cluster exchange, 0.7 of barrier) 6.8; the parts add up, they do not
// overlap.  Each block reads half of dz_{t+1}, 512 KiB at B = 64 (64 MiB a
// step over 128 blocks), through L2 into shared memory and out again.
// The first design, one block per 8 units reading all of dz_{t+1} (a (B,
// 4H) x (4H, 8) product a block), took 35 us a step in the same timing
// (products 11.5, copies 14, rest 8.5: twice the bytes through L2 and
// shared memory, and each A fragment split for one n8 tile); neither a
// deeper or shallower ring (8 to 20 chunks), nor chunks of 4 m16 tiles
// sharing one split of W_h (7.24-7.35 ms a launch against 5.74-5.98), nor
// each block taking the k16 blocks in its own order (6.2 against 5.8)
// moved it, and sharing each chunk between a cluster's 2 blocks by TMA
// multicast (boxes of 16 rows x 16 k, an mbarrier ring) took 14.7 ms.  A
// cluster of 4 is not resident at 128 blocks (error 720).  At B = 4 a step
// takes 5.7 us, by block 0's clock counts 55% in the copies and FMAs, 24%
// in the cell update and 20% in the barrier.
constexpr int kMaxBpttH = 1024;    // widest H of lstm_bptt_launch
constexpr int kUnitsB = 16;        // units a cluster: two n8 tiles
constexpr int kCellsB = kUnitsB / 2;  // units whose cells a block updates
constexpr int kRingB = 16;         // dz chunks a warp's ring holds
constexpr int kChunkB = 16 * 16;   // floats a chunk: 16 rows x 16 k
constexpr int kRowTileB = 64;      // batch rows a tile
constexpr int kSimtRowsB = 8;      // launches of at most this many rows: FMAs
constexpr int kLaunchRowsB = 512;  // batch rows a launch
constexpr int kNkB = 2 * kMaxBpttH / 16 / kWarpsG;  // k16 blocks a warp
// a launch of at most kSimtRowsB rows holds a step's dz in its warps' rings
static_assert(kRingB * kChunkB >= kMaxBpttH / 64 * 16 * kSimtRowsB,
              "the ring holds a step of the CUDA-core path");

size_t bptt_mma_smem_bytes(int rows) {
  return sizeof(float) * ((size_t)kWarpsG * kRingB * kChunkB +
                          2 * (size_t)kWarpsG * kRowTileB * kUnitsB +
                          2 * (size_t)kRowTileB * kCellsB +
                          (size_t)rows * kCellsB);
}

// The gate columns [0, kh) go to rank 0 of a cluster, [kh, 4H) to rank 1:
// kh = 2H rounded up to a k16 block, so both halves start 16-byte aligned.
__device__ __forceinline__ int k_half(int H) { return (2 * H + 15) & ~15; }

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// arrive at the cluster's barrier, then wait for the other block: the
// shared-memory writes before it are seen by both blocks after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// v into the float at the same offset as `p` in the cluster's block `rank`
__device__ __forceinline__ void st_cluster(float* p, unsigned rank, float v) {
  asm volatile(
      "{\n.reg .b32 r;\n"
      "mapa.shared::cluster.u32 r, %0, %1;\n"
      "st.shared::cluster.f32 [r], %2;\n}\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(p)),
      "r"(rank), "f"(v)
      : "memory");
}

template <int NK>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_bptt_mma_kernel(const float* __restrict__ wh,
                         const float* __restrict__ cseq,
                         const float* __restrict__ dy, float* dxw,
                         unsigned int* counter, int B, int T, int H) {
  constexpr int RS = kRowTileB * kUnitsB;  // partials of a warp
  constexpr int CT = 4 * NK;               // chunks of a full tile
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float* ring = smem + warp * kRingB * kChunkB;  // [kRingB][16][16]
  float* red = smem + kWarpsG * kRingB * kChunkB;  // [2][kWarpsG][64][16]
  float* xch = red + 2 * kWarpsG * RS;  // [2][64][8]: the partner's sums
  float* dcs = xch + 2 * kRowTileB * kCellsB;  // [B][8]: dc_next

  const int H4 = 4 * H;
  const unsigned rank = cluster_rank(), other = rank ^ 1;
  const int j0 = (blockIdx.x >> 1) * kUnitsB;
  const unsigned int nblk = gridDim.x;
  const int kh = k_half(H);
  const int kbase = rank ? kh : 0, klen = rank ? H4 - kh : kh;
  // the lane's first k of k16 block 0, in its block's half of the columns
  const int k0 = warp * 16 * NK + 4 * tig;

  // wf[kb][n][s][e] = W_h[j0 + 8 n + gid][kbase + k0 + 16 kb + 2 s + e]:
  // fragment b_e of k8 step s of k16 block kb, n8 tile n; zero past H and
  // past the half
  float wf[NK][2][2][2];
#pragma unroll
  for (int kb = 0; kb < NK; ++kb)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + 16 * kb + 2 * s + e, j = j0 + 8 * n + gid;
          wf[kb][n][s][e] = k < klen && j < H
                                ? __ldg(wh + (size_t)j * H4 + kbase + k)
                                : 0.0f;
        }
  for (int i = tid; i < B * kCellsB; i += kThreads) dcs[i] = 0.0f;

  // a step's chunks on the tensor-core path: CT for each full tile, then
  // the last tile's m16 tiles x NK
  const int ntiles = (B + kRowTileB - 1) / kRowTileB;
  const int nchunks =
      (ntiles - 1) * CT + (B - kRowTileB * (ntiles - 1) + 15) / 16 * NK;
  const bool simt = B <= kSimtRowsB;
  // cell role: rows cr and cr + 32 of a tile, unit cj of the block's 8;
  // the partner's unit cu (pj) is summed here too
  const int cr = tid / kCellsB, cu = tid % kCellsB;
  const int cj = j0 + kCellsB * rank + cu, pj = j0 + kCellsB * other + cu;
  // op[e]: the operands of cell (cr + 32 e, cj) in the tile of rows from r0
  // at step t, loaded one tile ahead of its cell update: gates i, f, g, o,
  // c_t, c_{t-1}, dy_t
  float op[2][7];
  auto load_op = [&](int r0, int t) {
    const int rows = min(kRowTileB, B - r0);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = cr + 32 * e;
      const bool cell = r < rows && cj < H;
      const size_t row = (size_t)(r0 + (cell ? r : 0)) * T + t;
      const int j = cell ? cj : 0;
      const float* gz = dxw + row * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) op[e][g] = cell ? __ldcg(gz + g * H) : 0.0f;
      op[e][4] = cell ? __ldg(cseq + row * H + j) : 0.0f;
      op[e][5] = cell && t > 0 ? __ldg(cseq + (row - 1) * H + j) : 0.0f;
      op[e][6] = cell ? __ldg(dy + row * H + j) : 0.0f;
    }
  };
  load_op(0, T - 1);
  int buf = 0;

  for (int t = T - 1; t >= 0; --t) {
    const bool next = t + 1 < T;  // dz_T = 0
    // row b of dz_{t+1} in the block's half of the columns: + b T 4H
    const float* zsrc = dxw + (size_t)(t + 1) * H4 + kbase;
    // chunk f: tile f / CT, its m16 tile p, k16 block kb; the lane copies
    // rows gid and gid + 8 at its k's
    auto copy_chunk = [&](int f) {  // one commit group, empty past the last
      if (f < nchunks) {
        const int tile = f / CT, rem = f - tile * CT;
        const int p = rem / NK, k = k0 + 16 * (rem - p * NK);
        float* dst = ring + (f % kRingB) * kChunkB + 16 * gid + 4 * tig;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = kRowTileB * tile + 16 * p + gid + 8 * e;
          const bool in = row < B && k < klen;
          cp_async16(dst + 128 * e,
                     in ? zsrc + (size_t)row * T * H4 + k : dxw,
                     in ? 16 : 0);
        }
      }
      cp_async_commit();
    };
    if (next && simt) {
      // a few rows: the lane copies row gid at its k's of every k16 block
      // at once, [kb][row][16 k] in its warp's ring, so the step waits for
      // one round trip to L2
      if (gid < B) {
        const float* src = zsrc + (size_t)gid * T * H4;
        float* dst = ring + 16 * gid + 4 * tig;
#pragma unroll
        for (int kb = 0; kb < NK; ++kb) {
          const int k = k0 + 16 * kb;
          cp_async16(dst + 128 * kb, k < klen ? src + k : dxw,
                     k < klen ? 16 : 0);
        }
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncwarp();
    } else if (next) {
      for (int f = 0; f < kRingB - 1; ++f) copy_chunk(f);
    }
    int f = 0;  // the chunk being multiplied
    // wait for chunk f (every lane's part), then refill the slot that
    // chunk f - 1 took, which every lane of the warp has read
    auto next_chunk = [&]() {
      cp_async_wait<kRingB - 2>();
      __syncwarp();
      copy_chunk(f + kRingB - 1);
      return ring + (f % kRingB) * kChunkB;
    };
    for (int r0 = 0; r0 < B; r0 += kRowTileB) {
      const int rows = min(kRowTileB, B - r0);
      float* rb = red + buf * kWarpsG * RS;
      if (next && simt) {
        // the same fragments on the CUDA cores; lane (gid, tig) holds W_h
        // at k0 + 16 kb + 0 .. 3 for units gid and 8 + gid
        float v[2 * kSimtRowsB];  // v[8 n + r]: row r, n8 tile n
#pragma unroll
        for (int i = 0; i < 2 * kSimtRowsB; ++i) v[i] = 0.0f;
#pragma unroll
        for (int kb = 0; kb < NK; ++kb) {
          const float* a = ring + 128 * kb + 4 * tig;
#pragma unroll
          for (int r = 0; r < kSimtRowsB; ++r) {
            if (r >= rows) break;
            const float4 zv = *reinterpret_cast<const float4*>(a + 16 * r);
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              float& acc = v[kSimtRowsB * n + r];
              acc = fmaf(zv.x, wf[kb][n][0][0], acc);
              acc = fmaf(zv.y, wf[kb][n][0][1], acc);
              acc = fmaf(zv.z, wf[kb][n][1][0], acc);
              acc = fmaf(zv.w, wf[kb][n][1][1], acc);
            }
          }
        }
        // sum over the units' 4 lanes: lane tig keeps n8 tile tig & 1,
        // rows 4 (tig >> 1) .. 4 (tig >> 1) + 3
        reduce_half<kSimtRowsB>(v, 1, tig & 1);
        reduce_half<kSimtRowsB / 2>(v, 2, tig & 2);
#pragma unroll
        for (int i = 0; i < kSimtRowsB / 2; ++i)
          rb[warp * RS + (4 * (tig >> 1) + i) * kUnitsB + 8 * (tig & 1) +
             gid] = v[i];
      } else if (next) {
#pragma unroll 1
        for (int p = 0; p < (rows + 15) / 16; ++p) {
          // W_h's fragments are the same for every m16 tile, and so are
          // their splits: an empty asm that may change them keeps each
          // split where it is used (lstm_recurrence_mma_kernel's note)
#pragma unroll
          for (int kb = 0; kb < NK; ++kb)
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int s = 0; s < 2; ++s)
                asm volatile("" : "+f"(wf[kb][n][s][0]), "+f"(wf[kb][n][s][1]));
          float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
          for (int kb = 0; kb < NK; ++kb, ++f) {
            const float* a = next_chunk() + 16 * gid + 4 * tig;
            const float4 lo = *reinterpret_cast<const float4*>(a);  // row gid
            const float4 hi = *reinterpret_cast<const float4*>(a + 128);
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              unsigned ah[4], al[4];
              split_tf32(s ? lo.z : lo.x, ah[0], al[0]);  // (gid, k)
              split_tf32(s ? hi.z : hi.x, ah[1], al[1]);  // (gid + 8, k)
              split_tf32(s ? lo.w : lo.y, ah[2], al[2]);  // (gid, k + 1)
              split_tf32(s ? hi.w : hi.y, ah[3], al[3]);  // (gid + 8, k + 1)
#pragma unroll
              for (int n = 0; n < 2; ++n) {
                unsigned bh[2], bl[2];
                split_tf32(wf[kb][n][s][0], bh[0], bl[0]);
                split_tf32(wf[kb][n][s][1], bh[1], bl[1]);
                float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma_tf32(d, al, bh);
                mma_tf32(d, ah, bl);
                mma_tf32(d, ah, bh);
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[n][i] += d[i];
              }
            }
          }
          // d_i holds row gid + 8 (i / 2), unit 8 n + 2 tig + i % 2
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              *reinterpret_cast<float2*>(
                  rb + warp * RS + (16 * p + gid + 8 * e) * kUnitsB + 8 * n +
                  2 * tig) = make_float2(acc[n][2 * e], acc[n][2 * e + 1]);
        }
      }
      __syncthreads();
      // the 8 warps' partials in warp order: this block's half of dh for
      // its own units, and for the partner's, which go to the partner
      float own[2] = {0.0f, 0.0f};
      float* xb = xch + buf * kRowTileB * kCellsB;
      if (next) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = cr + 32 * e;
          if (r >= rows) continue;
          float part = 0.0f;
#pragma unroll
          for (int w = 0; w < kWarpsG; ++w) {
            own[e] += rb[w * RS + r * kUnitsB + kCellsB * rank + cu];
            part += rb[w * RS + r * kUnitsB + kCellsB * other + cu];
          }
          if (pj < H) st_cluster(xb + r * kCellsB + cu, other, part);
        }
        cluster_sync();
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = cr + 32 * e;
        if (r >= rows || cj >= H) continue;
        // dh = dy_t + rank 0's half + rank 1's half, in that order in both
        // blocks
        float dh = op[e][6];
        if (next) {
          const float mine = own[e], theirs = xb[r * kCellsB + cu];
          dh += rank ? theirs : mine;
          dh += rank ? mine : theirs;
        }
        const float gi = op[e][0], gf = op[e][1], gg = op[e][2],
                    go = op[e][3];
        float& dc_next = dcs[(r0 + r) * kCellsB + cu];
        const float tc = tanhf(op[e][4]);
        const float dc = dh * go * (1.0f - tc * tc) + dc_next;
        float* dz = dxw + ((size_t)(r0 + r) * T + t) * H4 + cj;
        dz[0] = dc * gg * gi * (1.0f - gi);
        dz[H] = dc * op[e][5] * gf * (1.0f - gf);
        dz[2 * H] = dc * gi * (1.0f - gg * gg);
        dz[3 * H] = dh * tc * go * (1.0f - go);
        dc_next = dc * gf;
      }
      if (r0 + kRowTileB < B) {
        load_op(r0 + kRowTileB, t);
      } else if (t > 0) {
        load_op(0, t - 1);
      }
      buf ^= 1;
    }
    if (t > 0) grid_barrier_release(counter, nblk * (unsigned)(T - t));
  }
}

// Clusters of lstm_bptt_mma_kernel resident at once on the current device
// for a launch of `rows` rows (cfg: its shape and shared memory).  The
// attribute and the query are host-side calls whose answer depends on the
// device and the rows alone, so each (device, rows) asks once: the
// attribute is set to a full launch's shared memory, which covers every
// launch.
cudaError_t resident_clusters(cudaLaunchConfig_t* cfg, int rows,
                              int* clusters) {
  constexpr int kDevices = 16;  // devices with a cached answer
  static std::atomic<int> known[kDevices][kLaunchRowsB + 1];  // answer + 1
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::atomic<int>* slot = dev < kDevices ? &known[dev][rows] : nullptr;
  if (slot != nullptr && (*clusters = slot->load() - 1) >= 0)
    return cudaSuccess;
  const void* kernel = (const void*)lstm_bptt_mma_kernel<kNkB>;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           (int)bptt_mma_smem_bytes(kLaunchRowsB))) != cudaSuccess)
    return err;
  const unsigned n_attrs = cfg->numAttrs;
  cfg->numAttrs = 1;  // the residency query takes the cluster shape alone
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, cfg);
  cfg->numAttrs = n_attrs;
  if (err == cudaSuccess && slot != nullptr) slot->store(*clusters + 1);
  return err;
}

// Launches of up to kLaunchRowsB rows each, counters[i] the i-th's barrier:
// cooperative launches of clusters of 2 blocks, refused unless every
// cluster is resident at once.
cudaError_t launch_bptt_mma(const float* wh, const float* c, const float* dy,
                            float* dxw, unsigned int* counters, int B, int T,
                            int H, cudaStream_t st) {
  const int nblk = 2 * ((H + kUnitsB - 1) / kUnitsB);
  const void* kernel = (const void*)lstm_bptt_mma_kernel<kNkB>;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = 2;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblk);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  for (int b0 = 0; b0 < B; b0 += kLaunchRowsB) {
    int rows = std::min(kLaunchRowsB, B - b0);
    cfg.dynamicSmemBytes = bptt_mma_smem_bytes(rows);
    int clusters = 0;
    cudaError_t err = resident_clusters(&cfg, rows, &clusters);
    if (err != cudaSuccess) return err;
    if (2 * clusters < nblk) return cudaErrorCooperativeLaunchTooLarge;
    const float* c_i = c + (size_t)b0 * T * H;
    const float* dy_i = dy + (size_t)b0 * T * H;
    float* dxw_i = dxw + (size_t)b0 * T * 4 * H;
    unsigned int* counter = counters + b0 / kLaunchRowsB;
    void* args[] = {(void*)&wh,    (void*)&c_i,     (void*)&dy_i,
                    (void*)&dxw_i, (void*)&counter, (void*)&rows,
                    (void*)&T,     (void*)&H};
    if ((err = cudaLaunchKernelExC(&cfg, kernel, args)) != cudaSuccess)
      return err;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The loop kernel a launch at (B, H) runs; see lstm_bptt_launch.
enum class Kernel { kSmall, kGroup, kMma };

Kernel kernel_for(int H) {
  if (H <= kSmallH) return Kernel::kSmall;
  if (H > kMaxGroupH) return Kernel::kMma;
  return Kernel::kGroup;
}

}  // namespace

extern "C" {

// dz into dxw (B, T, 4H), H <= kMaxBpttH.  Returns a cudaError_t (0 on
// success).  `counters` must hold lstm_bptt_counters(B, H) zeroed uint32
// values.  The gate pre-pass writes dxw first and the loop reads it back
// in 16-byte copies, so dxw must be 16-byte aligned (any tensor that
// starts at a row); the inputs may start anywhere.
//
// Which loop kernel serves width H (kernel_for): lstm_bptt_small_kernel at
// H <= kSmallH (64), lstm_bptt_group_kernel at 64 < H <= kMaxGroupH (512,
// its register limit), lstm_bptt_mma_kernel above; all after the gate
// pre-pass.  A launch the card refuses returns its error: there is no
// other route.
int lstm_bptt_launch(const float* xw, const float* wh, const float* h,
                     const float* c, const float* dy, float* dxw,
                     unsigned int* counters, int B, int T, int H,
                     void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > kMaxBpttH)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(dxw)) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = launch_gates(xw, wh, h, dxw, B, T, H, st);
  if (err != cudaSuccess) return (int)err;
  switch (kernel_for(H)) {
    case Kernel::kSmall: {
      const int hp = H <= 32 ? 32 : 64;
      auto* kernel =
          hp == 32 ? lstm_bptt_small_kernel<32> : lstm_bptt_small_kernel<64>;
      kernel<<<B, 2 * hp, 0, st>>>(wh, c, dy, dxw, T, H);
      return (int)cudaGetLastError();
    }
    case Kernel::kGroup: {
      const auto launch = H <= 128   ? launch_bptt_group<2>
                          : H <= 256 ? launch_bptt_group<4>
                                     : launch_bptt_group<8>;
      return (int)launch(wh, c, dy, dxw, counters, B, T, H, st);
    }
    case Kernel::kMma:
      break;
  }
  return (int)launch_bptt_mma(wh, c, dy, dxw, counters, B, T, H, st);
}

// Barrier counters lstm_bptt_launch needs for a batch of B rows at width
// H: none at H <= kSmallH; at kSmallH < H <= kMaxGroupH one per group of
// kRowsG rows; above, one per launch of kLaunchRowsB rows.
int lstm_bptt_counters(int B, int H) {
  if (H <= kSmallH) return 0;
  if (H > kMaxGroupH) return (B + kLaunchRowsB - 1) / kLaunchRowsB;
  return (B + kRowsG - 1) / kRowsG;
}

// The name of the loop kernel lstm_bptt_launch runs at (B, H).  No loop
// kernel depends on B today (lstm_bptt_mma_kernel takes its FMA path for
// <= kSimtRowsB rows inside the same kernel); B stays in the signature so
// that the name is asked as the forward's lstm_recurrence_kernel_for(B, H).
const char* lstm_bptt_kernel_for(int /*B*/, int H) {
  switch (kernel_for(H)) {
    case Kernel::kSmall:
      return "lstm_bptt_small_kernel";
    case Kernel::kGroup:
      return "lstm_bptt_group_kernel";
    case Kernel::kMma:
      break;
  }
  return "lstm_bptt_mma_kernel";
}

// The gate pre-pass of lstm_bptt_launch alone (any H; above kSmallH gates
// must be 8-byte aligned): gates (B, T, 4H) = act(xw + h_{t-1} W_h), i, f,
// o through the sigmoid and g through tanh.
int lstm_gates_launch(const float* xw, const float* wh, const float* h,
                      float* gates, int B, int T, int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
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
