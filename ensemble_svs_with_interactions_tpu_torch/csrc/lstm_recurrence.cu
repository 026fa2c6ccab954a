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
// registers, a barrier per group of rows); above 512 the mma kernel.
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
// 512 < H <= 1024 (lstm_recurrence_mma_kernel, its own section below): a
// cooperative launch of 8 units a block that does a step's (B, H) x (H, 32)
// product for all batch rows at once on the tensor cores, in 3xTF32, with
// its slice of W_h in registers.  Wider LSTMs raise (kMaxMmaH), as the
// BPTT does.

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

// ------------------------------------------------------ 512 < H <= 1024
// lstm_recurrence_mma_kernel<NK, kVec>: past H = 512 the rows of W_h
// outgrow the group kernel's registers.  A cooperative launch of
// ceil(H / 8) blocks (128 at H = 1024, one an SM): block x owns kUnitsM =
// 8 units, j0 = 8 x .. 8 x + 7, i.e. the 32 gate columns g H + j, for
// every batch row, so the cell update stays in the block and the blocks
// trade only h, through L2, at one grid barrier a step
// (grid_barrier_release).  A step's work in a block is one
// (B, H) x (H, 32) product, h_{t-1} times the block's slice of W_h, for
// all batch rows at once on the tensor cores:
//   - 3xTF32 mma.sync.m16n8k8 (split_tf32, mma_tf32 and the precision
//     argument above lstm_dwh_kernel in lstm_bptt.cu: each k8 partial is
//     summed from zero, then added to an f32 sum).  Plain TF32 would keep
//     about three decimal digits of each product, which 1e-4 over
//     thousands of steps does not allow;
//   - split-K over the 8 warps: warp w sums over the hidden units
//     [16 NK w, 16 NK (w + 1)) of h (NK = ceil(H / 128) k16 blocks, zero
//     past H) and keeps its part of the slice, 16 NK x 32 floats, as B
//     fragments in registers for the whole sequence (128 a thread at H =
//     1024, split into hi and lo where they are used: the compiler must
//     not hoist the splits out of the loop over m16 tiles, where they
//     would need twice the registers), so no shared memory holds W_h and
//     none is read for it.  n8 tile q is gate q of the block's 8 units;
//   - inside each k16 block the k order is permuted, the same way for both
//     operands: lane (g, t) takes k = 4 t .. 4 t + 3, two a k8 step, so
//     its A fragment of rows g and g + 8 is two float4;
//   - h_{t-1} streams from y (written by every block at step t - 1) through
//     a kRingM-stage cp.async.cg ring per warp, one chunk (16 rows x 16 k)
//     a stage, kRingM - 1 chunks ahead of the one being multiplied; .cg
//     reads through L2, so it sees the other blocks' writes after the
//     barrier.  Each lane copies the two float4 of its own A fragment; a
//     warp sync after each wait lets the lanes read each other's rows (the
//     path below) and frees the slot the warp read last;
//   - a tile of at most kSimtRowsM = 8 rows (B = 1 serving, the 4 crops
//     of a small train step) skips the tensor cores, whose m16 tile would
//     be mostly padding: lane (g, t) multiplies the same W_h fragments,
//     which hold its 4 k's of unit g for each gate, by those k's of each
//     row in float32 FMAs, and the unit's 4 lanes meet by shuffles;
//   - the batch runs in tiles of kRowTileM = 64 rows (4 m16 tiles, rows
//     past B zero-filled by the copy), each tile's m16 tiles in turn, so
//     any B runs in the same registers.  A launch takes up to kLaunchRowsM
//     = 512 rows (their cells' c sits in shared memory); more rows take
//     more launches, one after another on the stream, each with its own
//     barrier counter.  No batch is refused for residency;
//   - a tile's 8 warps leave their partial sums in shared memory, the 4
//     gates of a (row, unit) side by side as one float4 (two buffers,
//     alternating by tile; unit slots XOR-swizzled by row, so both the
//     fragment-order writes and the row-order reads are conflict-free).
//     After one __syncthreads, thread (row, unit) sums the 8 partials in
//     warp order onto its xw (loaded a tile ahead, so behind the barrier
//     and the product): a fixed order
//     with no atomics, so two launches agree bitwise and h is the same with
//     and without c.  It applies sigmoid_f32 / tanhf, as the plain loop's
//     activations, keeps c in shared memory and writes h (and c).
// What bounds it: the step's latency, not bytes.  Timed on an H100
// (tools/bench_forward_builds.py) against builds that leave one part out,
// at B = 64, T = 128, H = 1024 with c (16.9 us a step): the products take
// about 9 us of it (6,144 mma.sync a block and step, about 10 cycles each
// with their operand splits and adds), the copies of h 1.7 us and the
// barrier 0.8 us.  Each block reads all of h_{t-1}, 256 KB at B = 64 (32
// MiB a step over 128 blocks), yet L2 does not bound the step, so the
// blocks share no copy through a cluster.  At B = 1 (4.2 us a step on the
// CUDA-core path) the barrier takes 1.0 us and the copies 0.3 us.
constexpr int kUnitsM = 8;          // units a block: 4 n8 tiles of gates
constexpr int kWarpsM = kThreads / 32;
constexpr int kRingM = 8;           // h chunks a warp's ring holds
constexpr int kChunkM = 16 * 16;    // floats a chunk: 16 rows x 16 k
constexpr int kRowTileM = 64;       // batch rows a tile
constexpr int kSimtRowsM = 8;       // tiles of at most this many rows: FMAs
constexpr int kLaunchRowsM = 512;   // batch rows a launch
constexpr int kMaxMmaH = 1024;      // NK <= 8: 128 registers of W_h

size_t mma_smem_bytes(int rows) {
  return sizeof(float) * ((size_t)kWarpsM * kRingM * kChunkM +
                          2 * (size_t)kWarpsM * kRowTileM * 4 * kUnitsM +
                          (size_t)rows * kUnitsM);
}

template <int NK, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    lstm_recurrence_mma_kernel(const float* __restrict__ xw,
                               const float* __restrict__ wh, float* y,
                               float* cseq, unsigned int* counter, int B,
                               int T, int H) {
  constexpr int RS = kRowTileM * kUnitsM;  // float4 partials of a warp
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float* ring = smem + warp * kRingM * kChunkM;  // [kRingM][16][16]
  float4* red = reinterpret_cast<float4*>(smem + kWarpsM * kRingM * kChunkM);
  float* cs = reinterpret_cast<float*>(red + 2 * kWarpsM * RS);  // [B][8]

  const int H4 = 4 * H;
  const int j0 = blockIdx.x * kUnitsM;
  const unsigned int nblk = gridDim.x;
  const int k0 = warp * 16 * NK + 4 * tig;  // lane's first k of k16 block 0

  // wf[kb][s][q][e] = W_h[k0 + 16 kb + 2 s + e][q H + j0 + gid]: fragment
  // b_e of k8 step s of k16 block kb, gate q; zero past H
  float wf[NK][2][4][2];
#pragma unroll
  for (int kb = 0; kb < NK; ++kb)
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + 16 * kb + 2 * s + e, j = j0 + gid;
          wf[kb][s][q][e] =
              k < H && j < H ? __ldg(wh + (size_t)k * H4 + q * H + j) : 0.0f;
        }
  for (int i = tid; i < B * kUnitsM; i += kThreads) cs[i] = 0.0f;

  const int nchunks = (B + 15) / 16 * NK;  // a warp's chunks a step
  // cell role: rows cr and cr + 32 of a tile, unit cj
  const int cr = tid / kUnitsM, cu = tid % kUnitsM, cj = j0 + cu;
  // xv[e][g]: xw of gate g of cell (cr + 32 e, cj) in the tile of rows
  // from r0 at step t, loaded one tile ahead of its cell update
  float xv[2][4];
  auto load_xv = [&](int r0, int t) {
    const int rows = min(kRowTileM, B - r0);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = cr + 32 * e;
      const bool cell = r < rows && cj < H;
      const float* src =
          xw + ((size_t)(r0 + (cell ? r : 0)) * T + t) * H4 + (cell ? cj : 0);
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[e][g] = cell ? __ldg(src + g * H) : 0.0f;
    }
  };
  load_xv(0, 0);
  int buf = 0;

  for (int t = 0; t < T; ++t) {
    const float* hsrc = y + (size_t)(t > 0 ? t - 1 : 0) * H;
    // chunk f: m16 tile f / NK of the launch, k16 block f % NK; the lane
    // copies rows gid and gid + 8 at its k's
    auto copy_chunk = [&](int f) {  // one commit group, empty past the last
      if (f < nchunks) {
        const int g = f / NK, k = k0 + 16 * (f - g * NK);
        float* dst = ring + (f % kRingM) * kChunkM + 16 * gid + 4 * tig;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 16 * g + gid + 8 * e;
          const float* src = hsrc + (size_t)row * T * H + k;
          if (kVec) {
            const bool in = row < B && k < H;
            cp_async16(dst + 128 * e, in ? src : y, in ? 16 : 0);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const bool in = row < B && k + i < H;
              cp_async4(dst + 128 * e + i, in ? src + i : y, in ? 4 : 0);
            }
          }
        }
      }
      cp_async_commit();
    };
    if (t > 0) {
      for (int f = 0; f < kRingM - 1; ++f) copy_chunk(f);
    }
    int f = 0;  // the chunk being multiplied
    // wait for chunk f (every lane's part), then refill the slot that
    // chunk f - 1 took, which every lane of the warp has read
    auto next_chunk = [&]() {
      cp_async_wait<kRingM - 2>();
      __syncwarp();
      copy_chunk(f + kRingM - 1);
      return ring + (f % kRingM) * kChunkM;
    };
    for (int r0 = 0; r0 < B; r0 += kRowTileM) {
      const int rows = min(kRowTileM, B - r0);
      float4* rb = red + buf * kWarpsM * RS;
      if (t > 0 && rows <= kSimtRowsM) {
        // a few rows: the same fragments and chunks on the CUDA cores;
        // lane (gid, tig) holds W_h at k0 + 16 kb + 0 .. 3 for unit gid
        float v[4 * kSimtRowsM];  // v[4 r + g]: row r, gate g
#pragma unroll
        for (int i = 0; i < 4 * kSimtRowsM; ++i) v[i] = 0.0f;
#pragma unroll
        for (int kb = 0; kb < NK; ++kb, ++f) {
          const float* a = next_chunk() + 4 * tig;
#pragma unroll
          for (int r = 0; r < kSimtRowsM; ++r) {
            if (r >= rows) break;
            const float4 hv = *reinterpret_cast<const float4*>(a + 16 * r);
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              float& acc = v[4 * r + g];
              acc = fmaf(hv.x, wf[kb][0][g][0], acc);
              acc = fmaf(hv.y, wf[kb][0][g][1], acc);
              acc = fmaf(hv.z, wf[kb][1][g][0], acc);
              acc = fmaf(hv.w, wf[kb][1][g][1], acc);
            }
          }
        }
        // sum over the unit's 4 lanes: lane tig keeps the kSimtRowsM / 4
        // rows from kSimtRowsM (2 (tig & 1) + (tig >> 1)) / 4
        reduce_half<2 * kSimtRowsM>(v, 1, tig & 1);
        reduce_half<kSimtRowsM>(v, 2, tig & 2);
#pragma unroll
        for (int i = 0; i < kSimtRowsM / 4; ++i) {
          const int row = kSimtRowsM * (2 * (tig & 1) + (tig >> 1)) / 4 + i;
          rb[warp * RS + row * kUnitsM + (gid ^ (row & 7))] =
              make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
        }
      } else if (t > 0) {
#pragma unroll 1
        for (int p = 0; p < (rows + 15) / 16; ++p) {
          // W_h's fragments are the same for every m16 tile, and so are
          // their splits: the compiler hoisted them out of this loop,
          // where hi and lo of all of them need twice the registers, and
          // spilled (444 bytes at NK = 8; 3.15 ms against 2.16 at B = 64,
          // T = 128 on an H100).  An empty asm that may change them keeps
          // each split where it is used.
#pragma unroll
          for (int kb = 0; kb < NK; ++kb)
#pragma unroll
            for (int s = 0; s < 2; ++s)
#pragma unroll
              for (int q = 0; q < 4; ++q)
                asm volatile("" : "+f"(wf[kb][s][q][0]), "+f"(wf[kb][s][q][1]));
          float acc[4][4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[q][i] = 0.0f;
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
              for (int q = 0; q < 4; ++q) {
                unsigned bh[2], bl[2];
                split_tf32(wf[kb][s][q][0], bh[0], bl[0]);
                split_tf32(wf[kb][s][q][1], bh[1], bl[1]);
                float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma_tf32(d, al, bh);
                mma_tf32(d, ah, bl);
                mma_tf32(d, ah, bh);
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[q][i] += d[i];
              }
            }
          }
          // d_i holds row gid + 8 (i / 2), unit 2 tig + i % 2
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = 16 * p + gid + 8 * (i >> 1);
            rb[warp * RS + row * kUnitsM + ((2 * tig + (i & 1)) ^ gid)] =
                make_float4(acc[0][i], acc[1][i], acc[2][i], acc[3][i]);
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = cr + 32 * e;
        if (r >= rows || cj >= H) continue;
        float z[4] = {xv[e][0], xv[e][1], xv[e][2], xv[e][3]};
        if (t > 0) {
#pragma unroll
          for (int w = 0; w < kWarpsM; ++w) {
            const float4 v = rb[w * RS + r * kUnitsM + (cu ^ (r & 7))];
            z[0] += v.x;
            z[1] += v.y;
            z[2] += v.z;
            z[3] += v.w;
          }
        }
        float& c_ref = cs[(r0 + r) * kUnitsM + cu];
        const float c =
            sigmoid_f32(z[1]) * c_ref + sigmoid_f32(z[0]) * tanhf(z[2]);
        const float h = sigmoid_f32(z[3]) * tanhf(c);
        c_ref = c;
        const size_t o = ((size_t)(r0 + r) * T + t) * H + cj;
        y[o] = h;
        if (cseq != nullptr) cseq[o] = c;
      }
      if (r0 + kRowTileM < B) {
        load_xv(r0 + kRowTileM, t);
      } else if (t + 1 < T) {
        load_xv(0, t + 1);
      }
      buf ^= 1;
    }
    if (t + 1 < T)
      grid_barrier_release(counter, nblk * (unsigned)(t + 1));
  }
}

// Launches of up to kLaunchRowsM rows each, counters[i] the i-th's barrier.
template <int NK>
cudaError_t launch_mma(const float* xw, const float* wh, float* y,
                       float* cseq, unsigned int* counters, int B, int T,
                       int H, cudaStream_t st) {
  const int nblk = (H + kUnitsM - 1) / kUnitsM;
  const void* kernel =
      H % 4 == 0 && aligned16(y)
          ? (const void*)lstm_recurrence_mma_kernel<NK, true>
          : (const void*)lstm_recurrence_mma_kernel<NK, false>;
  for (int b0 = 0; b0 < B; b0 += kLaunchRowsM) {
    int rows = std::min(kLaunchRowsM, B - b0);
    const size_t smem = mma_smem_bytes(rows);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const float* xw_i = xw + (size_t)b0 * T * 4 * H;
    float* y_i = y + (size_t)b0 * T * H;
    float* c_i = cseq != nullptr ? cseq + (size_t)b0 * T * H : nullptr;
    unsigned int* counter = counters + b0 / kLaunchRowsM;
    void* args[] = {(void*)&xw_i,    (void*)&wh, (void*)&y_i,
                    (void*)&c_i,     (void*)&counter, (void*)&rows,
                    (void*)&T,       (void*)&H};
    err = cudaLaunchCooperativeKernel(kernel, dim3(nblk), dim3(kThreads), args,
                                      smem, st);
    if (err != cudaSuccess) return err;
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The kernel a launch at (B, H) runs; see the rule above
// lstm_recurrence_launch.
enum class Kernel { kSmall, kGroup, kMma };

Kernel kernel_for(int B, int H) {
  if (H <= kSmallH) return Kernel::kSmall;
  if (H > kMaxGroupH) return Kernel::kMma;
  return Kernel::kGroup;
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 on success).  `counters` must hold
// lstm_recurrence_counters(B, H) zeroed uint32 values; `cseq` may be null.
// At H <= 64 xw must be 16-byte aligned (any tensor that starts at a row);
// H > kMaxMmaH (1024) is refused (cudaErrorInvalidValue).
//
// Which kernel serves (B, H) (kernel_for): lstm_recurrence_small_kernel at
// H <= 64, lstm_recurrence_group_kernel at 64 < H <= 512 (its register
// limit), lstm_recurrence_mma_kernel above.  The group kernel was faster
// than the split kernel that served 64 < H <= 512 before it at every
// shape timed, by device time in turns in one call on an H100
// (tools/bench_forward_builds.py): B = 4, T = 6656 17.90-17.92 ms against
// 25.91 at H = 512, 15.40 against 19.63 at 256; B = 64 with c, T = 256,
// 1.537-1.543 against 6.159-6.165 at 512 and 0.761-0.762 against
// 2.056-2.059 at 256; T = 64 0.189 against 0.526.
int lstm_recurrence_launch(const float* xw, const float* wh, float* y,
                           float* cseq, unsigned int* counters, int B, int T,
                           int H, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || H > kMaxMmaH)
    return (int)cudaErrorInvalidValue;
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
    case Kernel::kMma:
      break;
  }
  const auto launch = H <= 640   ? launch_mma<5>
                      : H <= 768 ? launch_mma<6>
                      : H <= 896 ? launch_mma<7>
                                 : launch_mma<8>;
  return (int)launch(xw, wh, y, cseq, counters, B, T, H, st);
}

// Number of barrier counters the launch needs for a batch of B rows at
// width H: none at H <= 64; at 64 < H <= 512 one per group of 4 rows (the
// group kernel's smallest group, so enough for any of its plans); above,
// one per launch of kLaunchRowsM rows.
int lstm_recurrence_counters(int B, int H) {
  if (H <= kSmallH) return 0;
  if (H > kMaxGroupH) return (B + kLaunchRowsM - 1) / kLaunchRowsM;
  return (B + 3) / 4;
}

// The name of the kernel lstm_recurrence_launch runs at (B, H).
const char* lstm_recurrence_kernel_for(int B, int H) {
  switch (kernel_for(B, H)) {
    case Kernel::kSmall:
      return "lstm_recurrence_small_kernel";
    case Kernel::kGroup:
      return "lstm_recurrence_group_kernel";
    case Kernel::kMma:
      break;
  }
  return "lstm_recurrence_mma_kernel";
}

const char* lstm_recurrence_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
