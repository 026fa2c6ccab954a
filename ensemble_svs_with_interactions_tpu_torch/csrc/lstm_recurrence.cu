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
// the latency of one step: reading h_{t-1}, the product, the cell update, a
// barrier, and (for H > 64) an exchange of h through L2 between blocks.
//
// Three designs, chosen by H (the rule above lstm_recurrence_launch): one
// block per batch row at H <= 64; at 64 < H <= 512 the group kernel (its
// own section below: 16 units x a group of rows a block, W_h rows in
// registers, a barrier per group of rows); above 512 the split kernel.
//
// H <= 64 (lstm_recurrence_small_kernel): W_h is at most 64 KB, so one block
// holds all of it, in registers.  The block's width is a compile-time
// padded HP = 32 or 64 (H = 62 runs as 64; padded units have zero weights,
// stay at h = c = 0 and are never written out).  Thread (u, s), 2 HP of
// them, holds the 4 gate columns of unit u over half s of the hidden units
// (2 HP weights): a step's dot product is 8 chains of HP / 4 FMAs over h
// read as float4 broadcasts, and the two halves meet with one __shfl_xor,
// after which both threads hold all 4 gate sums of their unit, so the cell
// update needs no trip through shared memory.  h_t goes to a
// double-buffered vector in shared memory, which leaves one __syncthreads
// per step.  What bounds a step, found on an H100 by taking its parts out
// one at a time: each scheduler runs one warp, so a step costs that warp's
// instruction stream with every dependent stall exposed (two rows in one
// block take twice as long as one).  The dot product is the largest part,
// then the activation chain.  So the per-step path is kept short: few
// warps with many columns each (16 HP threads of one column over a
// quarter of h took four times as long a step), activations from the
// hardware exp2 and reciprocal, and the step's xw loads issued before its
// dot product from a ring that is zero wherever nothing is copied, with no
// branch (read after the shuffles, in a branch per gate, they nearly
// doubled the step).  A block takes one batch row, so B = 4 runs on 4 SMs
// and B = 64 on 64; rows never meet, so no grid barrier is needed, and
// blocks past what the card holds at once queue: they cost no more than
// more rows per block would, since two rows in one block take twice as
// long as one.  xw rows stream in through an 8-step cp.async ring, far
// ahead of the step that reads them.
//
// H > 512 (lstm_recurrence_kernel): W_h is 4 MiB at H = 512 against 227 KB
// of shared memory per block, and past 512 its rows outgrow the group
// kernel's registers.  So:
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
//   * batch rows are independent: groups of up to kMaxRows rows run as
//     separate grid rows (blockIdx.y), each with its own barrier counter.
//     When the card cannot hold nblk blocks for every group (a training
//     batch: B = 64 at H = 512 asks for 2048 blocks), a grid row takes
//     several groups and runs the gate sums once per group inside each step
//     (lstm_common.cuh: plan_rows).  That is the kGrouped instantiation; a
//     grid row of one group runs the other;
//   * the xw values of step t+1 are loaded while step t finishes, so their
//     global-memory latency is off the critical path.
//   Inside a block, thread (k, s) sums column k of W_h over the hidden units
//   h = s, s+S, ...; the S partial sums meet with warp shuffles.

#include "lstm_common.cuh"

namespace {

using namespace lstm;

// ------------------------------------------------------------------ H <= 64
constexpr int kXwStages = 8;      // xw ring depth: steps in flight ahead

constexpr int kSlices = 2;        // threads per unit: halves of the h sum

// Thread tid is (unit u, slice s) = (tid / 2, tid % 2): it holds the 4 gate
// columns of unit u over the hidden units 4 (2q + s) + e, q < HP / 8.
// Block b runs batch row b.
template <int HP>
__global__ void __launch_bounds__(kSlices * HP)
    lstm_recurrence_small_kernel(const float* __restrict__ xw,
                                 const float* __restrict__ wh, float* y,
                                 float* cseq, int T, int H) {
  constexpr int kThreadsS = kSlices * HP;
  constexpr int kChunks = HP / (4 * kSlices);  // float4 chunks of h a slice
  __shared__ __align__(16) float hbuf[2][HP];            // h_{t-1} | h_t
  __shared__ __align__(16) float xs[kXwStages][4 * HP];  // xw ring

  const int tid = threadIdx.x;
  const int s = tid & 1, u = tid >> 1;
  const int H4 = 4 * H;
  const size_t row = blockIdx.x;
  const bool unit = u < H;

  float w[4][kChunks][4];  // W_h[4 (2q + s) + e][g H + u] in w[g][q][e]
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int q = 0; q < kChunks; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = 4 * (2 * q + s) + e;
        w[g][q][e] =
            (unit && hh < H) ? wh[(size_t)hh * H4 + g * H + u] : 0.0f;
      }
  for (int i = tid; i < 2 * HP; i += kThreadsS) (&hbuf[0][0])[i] = 0.0f;
  // the ring starts zeroed: columns past 4H are never copied, so they stay
  // 0, and a padded unit reads its xw there
  for (int i = tid; i < kXwStages * 4 * HP; i += kThreadsS)
    (&xs[0][0])[i] = 0.0f;
  int xo[4];  // this unit's xw columns in a ring row
#pragma unroll
  for (int g = 0; g < 4; ++g) xo[g] = unit ? g * H + u : 4 * H;
  __syncthreads();

  // xw copy role: thread tid < H moves 16 bytes (4 gate columns) a step
  const bool copier = tid < H;
  const float* xsrc = xw + row * T * H4 + 4 * (copier ? tid : 0);
  auto fetch = [&](int t) {  // one commit group per step, empty past T
    if (copier && t < T)
      cp_async16(&xs[t % kXwStages][4 * tid], xsrc + (size_t)t * H4);
    cp_async_commit();
  };
  for (int t = 0; t < kXwStages - 1; ++t) fetch(t);

  // this thread's output: h from slice 0, c from slice 1
  float* base = s == 0 ? y : cseq;
  float* out = (base != nullptr && unit) ? base + row * T * H + u : nullptr;
  float c = 0.0f;
  cp_async_wait<kXwStages - 2>();
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int cur = t & 1;
    const float* xt = xs[t % kXwStages];
    float xv[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) xv[g] = xt[xo[g]];
    float acc[4][2] = {};  // two FMA chains per gate
#pragma unroll
    for (int q = 0; q < kChunks; ++q) {
      const float4 hv =
          *reinterpret_cast<const float4*>(&hbuf[cur][4 * (2 * q + s)]);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float& a = acc[g][q & 1];
        a = fmaf(hv.x, w[g][q][0], a);
        a = fmaf(hv.y, w[g][q][1], a);
        a = fmaf(hv.z, w[g][q][2], a);
        a = fmaf(hv.w, w[g][q][3], a);
      }
    }
    float z[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      z[g] = acc[g][0] + acc[g][1];
      z[g] += __shfl_xor_sync(0xffffffffu, z[g], 1);
      z[g] += xv[g];
    }
    c = sigmoid_fast(z[1]) * c + sigmoid_fast(z[0]) * tanh_fast(z[2]);
    const float h = sigmoid_fast(z[3]) * tanh_fast(c);
    if (s == 0) hbuf[cur ^ 1][u] = unit ? h : 0.0f;
    if (out != nullptr) {
      *out = s == 0 ? h : c;
      out += H;
    }
    fetch(t + kXwStages - 1);  // into the slot step t - 1 read
    cp_async_wait<kXwStages - 2>();
    __syncthreads();
  }
}

// ------------------------------------------------------------------ H > 512
// Its one-block branches (nblk == 1) are no longer taken, since H <= 64 has
// its own kernel.  They stay: without them the single-group instantiation
// compiles to 57 registers instead of 64 and ran 6-9% slower at B = 4 on
// an H100.
template <bool kGrouped>
__global__ void __launch_bounds__(kThreads)
    lstm_recurrence_kernel(const float* __restrict__ xw,
                           const float* __restrict__ wh, float* y, float* cseq,
                           unsigned int* counters, int B, int T, int H, int U,
                           int S, int pitch, int gpb) {
  extern __shared__ float smem[];
  const int K = 4 * U;
  const int H4 = 4 * H;
  float* ws = smem;                    // [K][pitch]: this block's W_h columns
  float* hs = ws + K * pitch;          // [kMaxRows][H]: h_{t-1} of one group
  float* gs = hs + kMaxRows * H;       // [gpb * kMaxRows][K]: gate sums

  const int tid = threadIdx.x;
  const int nblk = gridDim.x;
  const int j0 = blockIdx.x * U;
  const int R = kGrouped ? gpb * kMaxRows : kMaxRows;  // rows per grid row
  const int b0 = blockIdx.y * R;
  const int rows = min(R, B - b0);
  const int ngroups = kGrouped ? (rows + kMaxRows - 1) / kMaxRows : 1;

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

  // cell role: pass q takes cell tid + q kThreads, batch row b2[q] of the
  // grid row and unit j2[q] (the grouped kernel's rows may outnumber the
  // threads: R U <= kCellPasses kThreads)
  constexpr int kPasses = kGrouped ? kCellPasses : 1;
  int b2[kPasses], j2[kPasses];
  bool cell_active[kPasses];
  const float* xrow[kPasses];
  float c[kPasses];
  float xg[kPasses][4];
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    const int ci = tid + q * kThreads;
    b2[q] = ci / U;
    j2[q] = j0 + ci % U;
    cell_active[q] = ci < R * U && b2[q] < rows && j2[q] < H;
    xrow[q] = cell_active[q] ? xw + (size_t)(b0 + b2[q]) * T * H4 + j2[q]
                             : xw;
    c[q] = 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      xg[q][g] = cell_active[q] ? xrow[q][g * H] : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    for (int grp = 0; grp < ngroups; ++grp) {
      const int gb = kGrouped ? grp * kMaxRows : 0;
      if (nblk > 1 && t > 0) {
        const int grows = kGrouped ? min(kMaxRows, rows - gb) : rows;
        for (int idx = tid; idx < grows * H; idx += kThreads) {
          const int b = idx / H, h = idx - (idx / H) * H;
          hs[b * H + h] =
              __ldcg(y + ((size_t)(b0 + gb + b) * T + (t - 1)) * H + h);
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
        for (int b = 0; b < kMaxRows; ++b) gs[(gb + b) * K + k1] = acc[b];
      }
      __syncthreads();
    }

#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      if (!cell_active[q]) continue;
      const int u = (tid + q * kThreads) % U;
      const float* g_row = gs + b2[q] * K;
      const float zi = xg[q][0] + g_row[u];
      const float zf = xg[q][1] + g_row[U + u];
      const float zg = xg[q][2] + g_row[2 * U + u];
      const float zo = xg[q][3] + g_row[3 * U + u];
      c[q] = sigmoid_f32(zf) * c[q] + sigmoid_f32(zi) * tanhf(zg);
      const float h = sigmoid_f32(zo) * tanhf(c[q]);
      const size_t o = ((size_t)(b0 + b2[q]) * T + t) * H + j2[q];
      y[o] = h;
      if (cseq != nullptr) cseq[o] = c[q];
      if (nblk == 1) hs[b2[q] * H + j2[q]] = h;
      if (t + 1 < T) {
        const float* nxt = xrow[q] + (size_t)(t + 1) * H4;
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[q][g] = nxt[g * H];
      }
    }
    if (nblk > 1) {
      grid_barrier(counters + blockIdx.y, (unsigned int)(nblk * (t + 1)));
    } else {
      __syncthreads();
    }
  }
}

size_t smem_bytes(const Split& p, int H, int gpb) {
  const int K = 4 * p.U;
  return sizeof(float) * ((size_t)K * p.pitch + (size_t)kMaxRows * H +
                          (size_t)gpb * kMaxRows * K);
}

// -------------------------------------------------------- 64 < H <= 512
// lstm_recurrence_group_kernel<NC, R>: a cooperative launch whose grid
// splits the units and the batch.  Block (x, y) owns kUnitsG = 16 units,
// j0 = 16 x .. 16 x + 15, all four gate columns of each (64 columns), for
// the groups of R = 4, 8 or 16 batch rows of grid row y; the blocks of a
// grid row exchange only their rows' h and meet at their own barrier
// (counters[y]).  The rows of W_h for the block's columns sit in registers
// for the whole sequence: thread (warp w, lane (cg, kq)), cg < 16, kq < 2,
// holds the 4 gate columns of unit j0 + cg over the float4 rows of W_h in
// k slice ks = 2 w + kq, i.e. W_h[4 (ks + 16 c) + e][g H + j0 + cg] for
// c < NC (H <= 64 NC): 16 NC floats, 128 at H = 512.  Each step, for each
// of the block's groups:
//   - each warp copies the h_{t-1} float4 columns its own lanes read (two
//     of every 16, all R rows) from y into shared memory with cp.async.cg,
//     which reads through L2 and so sees the other blocks' writes after
//     the barrier: one commit group per chunk c, kAheadF chunks ahead of
//     the one being multiplied; a warp waits only for its own copies
//     (__syncwarp), as lstm_bptt_group_kernel does with dz;
//   - cell thread (row, unit) = (tid / 16, tid % 16) loads its four xw
//     values of step t before the product and uses them after it;
//   - the product, in passes of 4 rows (a pass whose rows are all past B
//     is skipped, so B <= 4 does one pass whatever R is): each float4 of h
//     (a 16-lane broadcast) meets the thread's 4 columns, 16 FMAs a shared
//     load, into 16 sums; one reduce-scatter step over the lane pair kq
//     leaves each lane the sums of two of the pass's rows, and the 8
//     warps' partials meet in shared memory with the unit's four gates
//     side by side, read back as one float4 a warp and summed in warp
//     order (bitwise repeatable), one __syncthreads a group;
//   - that thread forms i, f, g, o, updates c (kept in shared memory, one
//     vector a group) and writes h (and c in the cseq mode).
// Then the grid row's barrier (grid_barrier_release).  R is the smallest
// of 4, 8, 16 at which every group of the batch has its own blocks
// resident at once (launch_group); past that, R = 16 and a block takes
// gpb groups in turn inside each step (plan_groups), and a launch that
// cannot fit raises.  Units past H have zero weights and are not written;
// rows past B are zero-filled and not written.  Where H is not a multiple
// of 4 (rows of h not 16-byte aligned) each warp copies its columns with
// __ldcg before the product instead (`vec` == 0).  What bounds it: the
// same step latency as above, now a product of 16 FMAs a shared load
// against W_h in registers, a barrier of H / 16 blocks, and h of the
// group's rows (32 KB at H = 512, R = 16) through L2 a step.  Timed in one
// call on an H100 against the first design (passes of 8 rows, 16-row
// groups at B > 4, the fenced grid_barrier; 296 bytes of spill at H =
// 512): 1.54 against 2.04 ms at B = 64, T = 256, H = 512 (6.0 us a step),
// 0.76 against 1.11 at H = 256, 17.9 against 21.3 at B = 4, T = 6656,
// H = 512; the release barrier alone is 17.9 against 20.1 ms there and
// 1.54 against 1.62 at B = 64.
constexpr int kSlicesF = 16;        // float4 row c of W_h is in k slice c % 16
constexpr int kAheadF = 3;          // h chunks in flight ahead of the one
                                    // being multiplied
constexpr int kPassRows = 4;        // rows a pass
constexpr int kWarpsF = kThreads / 32;
constexpr int kRedPitch = 4 * kUnitsG + 8;  // == 8 (mod 16): conflict-free

size_t group_smem_bytes(int nc, int R, int gpb) {
  return sizeof(float) * ((size_t)R * 4 * kSlicesF * nc +
                          2 * (size_t)kWarpsF * R * kRedPitch +
                          (size_t)gpb * kThreads);
}

template <int NC, int R>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_group_kernel(const float* __restrict__ xw,
                                 const float* __restrict__ wh, float* y,
                                 float* cseq, unsigned int* counters, int B,
                                 int T, int H, int gpb, int vec) {
  constexpr int P = 4 * kSlicesF * NC;  // h row pitch in floats, >= H
  constexpr int RP = kPassRows;
  constexpr int RQ = RP / 2;            // rows a lane keeps after the shuffle
  constexpr int RS = R * kRedPitch;     // one warp's partial sums
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;                     // [R][P]: h_{t-1} of a group
  float* red = hs + R * P;              // [2][kWarpsF][R][kRedPitch]
  float* cs = red + 2 * kWarpsF * RS;   // [gpb][kThreads]: c of each group

  const int H4 = 4 * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = lane >> 1, kq = lane & 1, ks = 2 * warp + kq;
  const int j0 = blockIdx.x * kUnitsG;
  const unsigned int nblk = gridDim.x;
  const int g0 = blockIdx.y * gpb;
  const int ngroups = min(gpb, (B + R - 1) / R - g0);

  float4 w[4][NC];  // W_h[4 (ks + 16 c) + e][g H + j0 + cg], zero past H
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int jw = j0 + cg, k = 4 * (ks + kSlicesF * c);
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        e[i] = jw < H && k + i < H ? __ldg(wh + (size_t)(k + i) * H4 +
                                           g * H + jw)
                                   : 0.0f;
      w[g][c] = make_float4(e[0], e[1], e[2], e[3]);
    }
  for (int g = 0; g < ngroups; ++g) cs[g * kThreads + tid] = 0.0f;
  // cell role: row r of the group, unit j
  const int r = tid / kUnitsG, u = tid % kUnitsG, j = j0 + u;
  int buf = 0;

  for (int t = 0; t < T; ++t) {
    for (int grp = 0; grp < ngroups; ++grp) {
      const int gb = (g0 + grp) * R;
      const int grows = min(R, B - gb);
      // lane (cg, kq) copies row cg (and cg + 16 ...) of float4 column
      // ks + 16 c: the columns its warp reads
      const float* ysrc = y + ((size_t)gb * T + (t > 0 ? t - 1 : 0)) * H;
      auto copy_chunk = [&](int c) {  // one commit group, empty past NC
        if (c < NC) {
          const int k = 4 * (ks + kSlicesF * c);
#pragma unroll
          for (int rr = cg; rr < R; rr += 16) {
            const bool in = rr < grows && k < H;
            cp_async16(hs + rr * P + k, in ? ysrc + (size_t)rr * T * H + k : y,
                       in ? 16 : 0);
          }
        }
        cp_async_commit();
      };
      if (t > 0) {
        if (vec) {
#pragma unroll
          for (int c = 0; c < kAheadF; ++c) copy_chunk(c);
        } else {
          for (int c = 0; c < NC; ++c) {
            const int k = 4 * (ks + kSlicesF * c);
            for (int rr = cg; rr < R; rr += 16) {
              const float* src = ysrc + (size_t)rr * T * H + k;
              float e[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                e[i] = rr < grows && k + i < H ? __ldcg(src + i) : 0.0f;
              *reinterpret_cast<float4*>(hs + rr * P + k) =
                  make_float4(e[0], e[1], e[2], e[3]);
            }
          }
          __syncwarp();
        }
      }
      const bool cell = r < grows && j < H;
      const size_t row = (size_t)(gb + (cell ? r : 0)) * T + t;
      float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (cell) {
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g] = __ldg(xw + row * H4 + g * H + j);
      }

      float* rb = red + buf * kWarpsF * RS;
      if (t > 0) {
#pragma unroll 1
        for (int pass = 0; pass < R / RP; ++pass) {
          if (pass > 0 && RP * pass >= grows) break;  // rows past B
          float v[4 * RP];  // v[4 rr + g]: row RP pass + rr, gate g
#pragma unroll
          for (int i = 0; i < 4 * RP; ++i) v[i] = 0.0f;
          const float* col = hs + RP * pass * P + 4 * ks;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            if (pass == 0 && vec) {
              copy_chunk(c + kAheadF);
              cp_async_wait<kAheadF>();  // this lane's chunk c landed
              __syncwarp();              // and the warp's
            }
#pragma unroll
            for (int rr = 0; rr < RP; ++rr) {
              const float4 hv = *reinterpret_cast<const float4*>(
                  col + rr * P + 4 * kSlicesF * c);
#pragma unroll
              for (int g = 0; g < 4; ++g) {
                float& a = v[4 * rr + g];
                a = fmaf(hv.x, w[g][c].x, a);
                a = fmaf(hv.y, w[g][c].y, a);
                a = fmaf(hv.z, w[g][c].z, a);
                a = fmaf(hv.w, w[g][c].w, a);
              }
            }
          }
          reduce_half<2 * RP>(v, 1, kq);
#pragma unroll
          for (int i = 0; i < RQ; ++i)
            *reinterpret_cast<float4*>(
                rb + warp * RS + (RP * pass + RQ * kq + i) * kRedPitch +
                4 * cg) = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                      v[4 * i + 3]);
        }
      }
      __syncthreads();

      if (cell) {
        if (t > 0) {
#pragma unroll
          for (int k = 0; k < kWarpsF; ++k) {
            const float4 s = *reinterpret_cast<const float4*>(
                rb + k * RS + r * kRedPitch + 4 * u);
            z[0] += s.x;
            z[1] += s.y;
            z[2] += s.z;
            z[3] += s.w;
          }
        }
        float& c_ref = cs[grp * kThreads + tid];
        const float c = sigmoid_fast(z[1]) * c_ref +
                        sigmoid_fast(z[0]) * tanh_fast(z[2]);
        const float h = sigmoid_fast(z[3]) * tanh_fast(c);
        c_ref = c;
        y[row * H + j] = h;
        if (cseq != nullptr) cseq[row * H + j] = c;
      }
      buf ^= 1;
    }
    if (t + 1 < T)
      grid_barrier_release(counters + blockIdx.y, nblk * (unsigned)(t + 1));
  }
}

template <int NC, int R>
cudaError_t plan_group(int B, int nblk, GroupPlan* g) {
  return plan_groups(
      lstm_recurrence_group_kernel<NC, R>, (B + R - 1) / R, nblk,
      [](int gpb) { return group_smem_bytes(NC, R, gpb); }, g);
}

// Rows a group: the smallest R whose groups all have their own blocks at
// once, else 16 with several groups a block.
template <int NC>
cudaError_t launch_group(const float* xw, const float* wh, float* y,
                         float* cseq, unsigned int* counters, int B, int T,
                         int H, cudaStream_t st) {
  const int nblk = (H + kUnitsG - 1) / kUnitsG;
  GroupPlan g;
  cudaError_t err;
  const void* kernel = (const void*)lstm_recurrence_group_kernel<NC, 4>;
  if ((err = plan_group<NC, 4>(B, nblk, &g)) != cudaSuccess) return err;
  if (g.gpb > 1) {
    kernel = (const void*)lstm_recurrence_group_kernel<NC, 8>;
    if ((err = plan_group<NC, 8>(B, nblk, &g)) != cudaSuccess) return err;
  }
  if (g.gpb > 1) {
    kernel = (const void*)lstm_recurrence_group_kernel<NC, 16>;
    if ((err = plan_group<NC, 16>(B, nblk, &g)) != cudaSuccess) return err;
  }
  int gpb = g.gpb;
  int vec = H % 4 == 0 && aligned16(y);
  void* args[] = {(void*)&xw, (void*)&wh, (void*)&y,   (void*)&cseq,
                  (void*)&counters, (void*)&B, (void*)&T, (void*)&H,
                  (void*)&gpb, (void*)&vec};
  err = cudaLaunchCooperativeKernel(kernel, dim3(nblk, g.grid_rows),
                                    dim3(kThreads), args, g.smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The kernel a launch at (B, H) runs; see the rule above
// lstm_recurrence_launch.
enum class Kernel { kSmall, kGroup, kSplit };

Kernel kernel_for(int B, int H) {
  if (H <= kSmallH) return Kernel::kSmall;
  if (H > kMaxGroupH) return Kernel::kSplit;
  return Kernel::kGroup;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  `counters` must hold
// lstm_recurrence_counters(B, H) zeroed uint32 values; `cseq` may be null.
// At H <= 64 xw must be 16-byte aligned (any tensor that starts at a row).
//
// Which kernel serves (B, H) (kernel_for): lstm_recurrence_small_kernel at
// H <= 64, lstm_recurrence_group_kernel at 64 < H <= 512 (its register
// limit), lstm_recurrence_kernel above.  The group kernel was faster than
// lstm_recurrence_kernel at every shape timed, by device time in turns in
// one call on an H100 (tools/bench_forward_builds.py): B = 4, T = 6656
// 17.90-17.92 ms against 25.91 at H = 512, 15.40 against 19.63 at 256;
// B = 64 with c, T = 256, 1.537-1.543 against 6.159-6.165 at 512 and
// 0.761-0.762 against 2.056-2.059 at 256; T = 64 0.189 against 0.526.
int lstm_recurrence_launch(const float* xw, const float* wh, float* y,
                           float* cseq, unsigned int* counters, int B, int T,
                           int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (kernel_for(B, H)) {
    case Kernel::kSmall: {
      if (!aligned16(xw)) return (int)cudaErrorMisalignedAddress;
      const int hp = H <= 32 ? 32 : 64;
      auto* kernel = hp == 32 ? lstm_recurrence_small_kernel<32>
                              : lstm_recurrence_small_kernel<64>;
      kernel<<<B, kSlices * hp, 0, st>>>(xw, wh, y, cseq, T, H);
      return (int)cudaGetLastError();
    }
    case Kernel::kGroup: {
      const auto launch = H <= 128   ? launch_group<2>
                          : H <= 256 ? launch_group<4>
                                     : launch_group<8>;
      return (int)launch(xw, wh, y, cseq, counters, B, T, H, st);
    }
    case Kernel::kSplit:
      break;
  }
  const Split p = make_split(H);
  const auto smem_for = [&](int gpb) { return smem_bytes(p, H, gpb); };
  // one group per grid row if the single-group kernel fits, else groups
  Rows r;
  cudaError_t err = plan_rows(lstm_recurrence_kernel<false>, B, p.U, p.nblk,
                              smem_for, &r);
  if (err != cudaSuccess) return (int)err;
  auto* kernel = lstm_recurrence_kernel<false>;
  if (r.gpb > 1) {
    kernel = lstm_recurrence_kernel<true>;
    err = plan_rows(kernel, B, p.U, p.nblk, smem_for, &r);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = smem_for(r.gpb);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.nblk, r.grid_rows);
  int U = p.U, S = p.S, pitch = p.pitch, gpb = r.gpb;
  void* args[] = {(void*)&xw, (void*)&wh, (void*)&y,     (void*)&cseq,
                  (void*)&counters, (void*)&B, (void*)&T, (void*)&H,
                  (void*)&U,  (void*)&S,  (void*)&pitch, (void*)&gpb};
  err = cudaLaunchCooperativeKernel((const void*)kernel, grid,
                                    dim3(kThreads), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Number of barrier counters the launch needs for a batch of B rows at
// width H: none at H <= 64, else one per group of kMaxRows rows (enough
// for any grid-row plan of either multi-block kernel).
int lstm_recurrence_counters(int B, int H) {
  return H <= kSmallH ? 0 : (B + kMaxRows - 1) / kMaxRows;
}

// The name of the kernel lstm_recurrence_launch runs at (B, H).
const char* lstm_recurrence_kernel_for(int B, int H) {
  switch (kernel_for(B, H)) {
    case Kernel::kSmall:
      return "lstm_recurrence_small_kernel";
    case Kernel::kGroup:
      return "lstm_recurrence_group_kernel";
    case Kernel::kSplit:
      break;
  }
  return "lstm_recurrence_kernel";
}

const char* lstm_recurrence_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
