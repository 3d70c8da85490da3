// Mamba-1 selective scan, backward, for Hopper (sm_90a).
//
// No TPU counterpart: the Pallas kernel
// src/repro/kernels/selective_scan/scan.py::selective_scan_pallas is forward
// only, and JAX trains through the jnp chunked scan
// (src/repro/models/ssm.py::selective_scan), which XLA differentiates.  This
// is the gradient of the port's forward (selective_scan.cu):
//   h_t = e_t * h_{t-1} + u_t B_t,  e_t = exp(dt_t A[d]),  u_t = dt_t x_t
//   y_t = C_t . h_t + D[d] x_t
// Given dy it runs the reverse recurrence per channel,
//   lam_t = dy_t C_t + e_{t+1} * lam_{t+1}          (dL/dh_t, in R^N)
//   d(dt)_t = sum_n lam_t h_{t-1} e_t A + (lam_t . B_t) x_t
//   dx_t = (lam_t . B_t) dt_t + dy_t D
//   dA += lam_t h_{t-1} e_t dt_t,  dD += dy_t x_t
//   dB_t += lam_t u_t,  dC_t += dy_t h_t       (summed over channels)
// dt/x/dy f32[B,S,di], B/C f32[B,S,N], A f32[di,N], D f32[di] -> d(dt), dx
// f32[B,S,di], dB, dC f32[B,S,N], dA f32[di,N], dD f32[di].
//
// Bound on the card: at falcon-mamba-7b's training shape ([2, 2048, 8192],
// N=16) it must read dt, x, dy and write d(dt), dx: 5 x 134 MB, 0.20 ms at
// 3.35 TB/s, against 537M exponentials, 0.13 ms at the SFU rate: bound by
// bytes.  It replaces a design (lane-split-recompute) whose every step
// loaded its inputs straight from device memory and waited on them, and
// whose 96 KB of shared memory let two blocks onto an SM.
//
// The design, staged-recompute:
// - the forward's layout: a block is 32 channels of one batch row, each
//   channel's N states split over N/4 lanes of 4 (128 threads at N=16);
// - the forward's staging: dt, x and dy for 32 timesteps x 32 channels,
//   and B and C for the same 32 timesteps, are copied into shared memory
//   with cp.async, double-buffered, the next chunk in flight while one is
//   computed; pass 1 runs the chunks in forward order, pass 2 in reverse,
//   so no timestep waits on device memory;
// - the forward saves nothing for it: pass 1 reruns the forward recurrence
//   (8 timesteps a round: their exponentials are independent, only h is
//   chained) and writes h at the start of every 32-step chunk to scratch,
//   f32 [B, S/32, di, N]: the checkpoint stride is the staged chunk;
// - pass 2 takes a chunk's saved state with its staged inputs, reruns its
//   first 16 steps to reach the state at step 16 (kept in shared memory
//   beside the saved one), then for each 16-step half, the later one
//   first, recomputes the half's states into registers (15 x 4 a lane: the
//   reverse reads h_{t-1}) and steps back through them carrying
//   e_{t+1} * lam_{t+1}; the loops are unrolled, so the exponentials of
//   different steps interleave and only h or lam is chained;
// - sums over a channel's states run over a lane's 4 then a __shfl_xor
//   tree.  dC_t = dy_t h_t is summed over the warp's channels while the
//   states are recomputed, dB_t = lam_t u_t while stepping back, each by a
//   fixed butterfly that leaves each of the N sums in one lane; then over
//   the block's warps in warp order through shared memory, written per
//   block of channels; d(dt) and dx of a half are written from shared
//   memory, coalesced; dA and dD accumulate over time in registers and
//   are written per batch row;
// - sum_leading adds those partials over batch rows (dA, dD) and channel
//   blocks (dB, dC) in index order.
// So every sum runs in one fixed order, with no float atomics, and two runs
// give the same bits.  50 KB of shared memory and at most 128 registers a
// thread fit 4 blocks on an SM: falcon's 512 blocks run in one wave on 132
// SMs.  h keeps the forward's operation order, e*h + (dt*x)*B.  Timesteps
// past S are zero filled on load, which makes them exact no-ops (h stays,
// lam stays 0), and are never stored.  expf, not __expf; no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

constexpr int CPB = 32;         // channels per block
constexpr int TCH = 32;         // timesteps a staged chunk and checkpoint
constexpr int SPL = 4;          // states per lane
constexpr int ROUND = 8;        // timesteps of pass 1 a lane takes together
constexpr int HALF = 16;        // timesteps a lane steps back through at once
static_assert(TCH == 2 * HALF, "a chunk is two halves");

template <int N>
struct Stage {
  float dt[TCH][CPB];
  float x[TCH][CPB];
  float dy[TCH][CPB];           // pass 2 only
  float b[TCH][N];
  float c[TCH][N];              // pass 2 only
  float h0[CPB * N];            // pass 2: the chunk's saved state, by thread
};

template <int N>
struct Smem {
  Stage<N> stage[2];
  float part[HALF][N / SPL][2 * N];   // dB, dC over each warp's channels
  float odt[HALF][CPB];               // d(dt) of a half, by channel
  float odx[HALF][CPB];
  float mid[CPB * N];                 // the state at step 16, by thread
};

// U timesteps tt..tt+U-1 of the forward recurrence for one lane (the
// plain version's arithmetic, in order for h); the U steps' exponentials
// are independent
template <int U, int N>
__device__ __forceinline__ void fwd_steps(const Stage<N>& sg, int tt,
                                          int ch, int sub,
                                          const float (&av)[SPL],
                                          float (&h)[SPL]) {
  float u[U], e[U][SPL];
  float4 bv[U];
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const float dtv = sg.dt[tt + k][ch];
    u[k] = dtv * sg.x[tt + k][ch];
    bv[k] = *reinterpret_cast<const float4*>(&sg.b[tt + k][SPL * sub]);
#pragma unroll
    for (int i = 0; i < SPL; ++i) e[k][i] = expf(dtv * av[i]);
  }
#pragma unroll
  for (int k = 0; k < U; ++k) {
    h[0] = e[k][0] * h[0] + u[k] * bv[k].x;
    h[1] = e[k][1] * h[1] + u[k] * bv[k].y;
    h[2] = e[k][2] * h[2] + u[k] * bv[k].z;
    h[3] = e[k][3] * h[3] + u[k] * bv[k].w;
  }
}

// v[i] (a dB or dC term of this lane's state i) summed over the warp's
// channels by a fixed butterfly on the lane bits above the state lanes:
// halving on bits 4 and 3 leaves lane L the sum of v[i], i = bits 4..3 of
// L, over the lanes that differ in those bits; the channel bits below
// them are then summed whole, and the lanes where those are 0 hold the N
// distinct sums (`sum_slot`)
template <int LANES>
__device__ __forceinline__ float channel_sum(const float (&v)[SPL],
                                             int lane) {
  const bool b4 = lane & 16, b3 = lane & 8;
  float a[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    a[j] = (b4 ? v[j + 2] : v[j]) +
           __shfl_xor_sync(0xffffffffu, b4 ? v[j] : v[j + 2], 16);
  float r = (b3 ? a[1] : a[0]) +
            __shfl_xor_sync(0xffffffffu, b3 ? a[0] : a[1], 8);
#pragma unroll
  for (int off = 4; off >= LANES; off >>= 1)
    r += __shfl_xor_sync(0xffffffffu, r, off);
  return r;
}

// the state (0..N-1) whose channel sum lane `lane` holds after
// channel_sum, or -1 if another lane holds the same sum
template <int LANES>
__device__ __forceinline__ int sum_slot(int lane) {
  if (lane & (7 & ~(LANES - 1))) return -1;
  return SPL * (lane % LANES) + (lane >> 3);
}

template <int N>
__global__ void __launch_bounds__(CPB * N / SPL, 4)
scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ x,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ a, const float* __restrict__ dskip,
                const float* __restrict__ dy, float* __restrict__ hs,
                float* __restrict__ ddt, float* __restrict__ dx,
                float* __restrict__ pb, float* __restrict__ pc,
                float* __restrict__ pa, float* __restrict__ pd, int bsz,
                int s, int di) {
  constexpr int LANES = N / SPL;                    // lanes a channel
  constexpr int THREADS = CPB * LANES;
  constexpr int NW = THREADS / 32;                  // warps a block
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);

  const int tid = threadIdx.x;
  const int ch = tid / LANES;                       // channel in the block
  const int sub = tid % LANES;                      // states SPL*sub ...
  const int lane = tid % 32, warp = tid / 32;
  const int slot = sum_slot<LANES>(lane);           // of the channel sums
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + ch;
  const bool live = d < di;
  // 16-byte copies where rows and bases allow them, else 4-byte copies
  const bool vec_dx =
      di % 4 == 0 && ((uintptr_t)dt | (uintptr_t)x | (uintptr_t)dy) % 16 == 0;
  const bool vec_bc = ((uintptr_t)bm | (uintptr_t)cm) % 16 == 0;
  const int64_t row = (int64_t)b * s;               // [b, 0] of [B, S, *]
  const int64_t prow = ((int64_t)blockIdx.x * bsz + b) * s;   // of pb, pc
  const int n_chunks = (s + TCH - 1) / TCH;
  // h at the start of chunk c, this lane's 4 states: saved + c * di * N
  const int64_t saved = (((int64_t)b * n_chunks) * di + d) * N + SPL * sub;

  float av[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i)
    av[i] = live ? a[(int64_t)d * N + SPL * sub + i] : 0.f;
  const float dsk = live ? dskip[d] : 0.f;

  // stage chunk `c` (timesteps TCH*c ...) into buffer `buf`: dt, x and B,
  // and for pass 2 (`rev`) dy, C and the chunk's saved state; always
  // commits a group, empty or not, so the waits count uniformly
  auto load = [&](int c, int buf, bool rev) {
    if (c >= 0 && c < n_chunks) {
      Stage<N>& sg = sm.stage[buf];
      const int t0 = c * TCH;
      if (vec_dx) {
        for (int i = tid; i < TCH * CPB / 4; i += THREADS) {
          const int tt = i / (CPB / 4), j = 4 * (i % (CPB / 4));
          const bool ok = t0 + tt < s && d0 + j < di;
          const int64_t off = ok ? (row + t0 + tt) * di + d0 + j : 0;
          scan::cp_async16(&sg.dt[tt][j], dt + off, ok);
          scan::cp_async16(&sg.x[tt][j], x + off, ok);
          if (rev) scan::cp_async16(&sg.dy[tt][j], dy + off, ok);
        }
      } else {
        for (int i = tid; i < TCH * CPB; i += THREADS) {
          const int tt = i / CPB, j = i % CPB;
          const bool ok = t0 + tt < s && d0 + j < di;
          const int64_t off = ok ? (row + t0 + tt) * di + d0 + j : 0;
          scan::cp_async4(&sg.dt[tt][j], dt + off, ok);
          scan::cp_async4(&sg.x[tt][j], x + off, ok);
          if (rev) scan::cp_async4(&sg.dy[tt][j], dy + off, ok);
        }
      }
      const int64_t bc0 = (row + t0) * N;
      if (vec_bc) {
        for (int i = 4 * tid; i < TCH * N; i += 4 * THREADS) {
          const bool ok = t0 + i / N < s;
          scan::cp_async16(&sg.b[0][i], bm + (ok ? bc0 + i : 0), ok);
          if (rev) scan::cp_async16(&sg.c[0][i], cm + (ok ? bc0 + i : 0), ok);
        }
      } else {
        for (int i = tid; i < TCH * N; i += THREADS) {
          const bool ok = t0 + i / N < s;
          scan::cp_async4(&sg.b[0][i], bm + (ok ? bc0 + i : 0), ok);
          if (rev) scan::cp_async4(&sg.c[0][i], cm + (ok ? bc0 + i : 0), ok);
        }
      }
      if (rev)
        scan::cp_async16(&sg.h0[SPL * tid],
                         hs + (live ? saved + (int64_t)c * di * N : 0), live);
    }
    scan::cp_async_commit();
  };

  // pass 1: the forward recurrence, h saved at the start of each chunk
  // (the last chunk's steps are not needed)
  {
    float h[SPL] = {0.f, 0.f, 0.f, 0.f};
    load(0, 0, false);
    load(1, 1, false);
    for (int c = 0; c < n_chunks; ++c) {
      scan::cp_async_wait<1>();                     // chunk c landed
      __syncthreads();
      if (live)
        *reinterpret_cast<float4*>(hs + saved + (int64_t)c * di * N) =
            make_float4(h[0], h[1], h[2], h[3]);
      if (c + 1 < n_chunks) {
        const Stage<N>& sg = sm.stage[c & 1];
#pragma unroll 1
        for (int tt = 0; tt < TCH; tt += ROUND)
          fwd_steps<ROUND>(sg, tt, ch, sub, av, h);
      }
      __syncthreads();                              // chunk c is consumed
      load(c + 2, c & 1, false);
    }
  }

  // pass 2: the chunks in reverse
  float lam[SPL], da[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) lam[i] = da[i] = 0.f;
  float dd = 0.f;
  load(n_chunks - 1, 0, true);
  load(n_chunks - 2, 1, true);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c = n_chunks - 1 - ci;
    scan::cp_async_wait<1>();                       // chunk c landed
    __syncthreads();
    const Stage<N>& sg = sm.stage[ci & 1];

    // the state at step 16, from the chunk's saved one; both stay in
    // shared memory for the halves
    const float* saved_h = &sg.h0[SPL * tid];
    float* mid_h = &sm.mid[SPL * tid];
    {
      float h[SPL] = {saved_h[0], saved_h[1], saved_h[2], saved_h[3]};
#pragma unroll
      for (int tt = 0; tt < HALF; tt += ROUND)
        fwd_steps<ROUND>(sg, tt, ch, sub, av, h);
#pragma unroll
      for (int i = 0; i < SPL; ++i) mid_h[i] = h[i];
    }

#pragma unroll 1
    for (int half = 1; half >= 0; --half) {
      const float* h0 = half ? mid_h : saved_h;     // the half's start
      // the half's states, recomputed: h_t into registers for the reverse
      // (all but the last, which it does not read), dC_t = dy_t h_t summed
      // over channels on the way
      float hist[HALF - 1][SPL];
      {
        float h[SPL] = {h0[0], h0[1], h0[2], h0[3]};
#pragma unroll
        for (int k = 0; k < HALF; ++k) {
          const int tt = half * HALF + k;
          const float dtv = sg.dt[tt][ch];
          const float u = dtv * sg.x[tt][ch];
          const float g = sg.dy[tt][ch];
          const float4 bv =
              *reinterpret_cast<const float4*>(&sg.b[tt][SPL * sub]);
          h[0] = expf(dtv * av[0]) * h[0] + u * bv.x;
          h[1] = expf(dtv * av[1]) * h[1] + u * bv.y;
          h[2] = expf(dtv * av[2]) * h[2] + u * bv.z;
          h[3] = expf(dtv * av[3]) * h[3] + u * bv.w;
          float v[SPL];
#pragma unroll
          for (int i = 0; i < SPL; ++i) {
            if (k < HALF - 1) hist[k][i] = h[i];
            v[i] = g * h[i];                        // dC_t, state i
          }
          const float r = channel_sum<LANES>(v, lane);
          if (slot >= 0) sm.part[k][warp][N + slot] = r;
        }
      }
      // back through them
#pragma unroll
      for (int k = HALF - 1; k >= 0; --k) {
        const int tt = half * HALF + k;
        const float g = sg.dy[tt][ch], dtv = sg.dt[tt][ch], xv = sg.x[tt][ch];
        const float u = dtv * xv;
        const float4 b4 =
            *reinterpret_cast<const float4*>(&sg.b[tt][SPL * sub]);
        const float4 c4 =
            *reinterpret_cast<const float4*>(&sg.c[tt][SPL * sub]);
        const float bv[SPL] = {b4.x, b4.y, b4.z, b4.w};
        const float cv[SPL] = {c4.x, c4.y, c4.z, c4.w};
        float part_dt = 0.f, part_u = 0.f, v[SPL];
#pragma unroll
        for (int i = 0; i < SPL; ++i) {
          const float hprev = k > 0 ? hist[k - 1][i] : h0[i];
          const float e = expf(dtv * av[i]);
          const float lt = g * cv[i] + lam[i];
          v[i] = lt * u;                            // dB_t, state i
          const float de = lt * hprev * e;          // dL/d(dt*A), state i
          part_dt += de * av[i];
          da[i] += de * dtv;
          part_u += lt * bv[i];
          lam[i] = e * lt;
        }
#pragma unroll
        for (int off = 1; off < LANES; off <<= 1) {
          part_dt += __shfl_xor_sync(0xffffffffu, part_dt, off);
          part_u += __shfl_xor_sync(0xffffffffu, part_u, off);
        }
        if (sub == 0) {
          sm.odt[k][ch] = part_dt + part_u * xv;
          sm.odx[k][ch] = part_u * dtv + g * dsk;
        }
        dd += g * xv;
        const float r = channel_sum<LANES>(v, lane);
        if (slot >= 0) sm.part[k][warp][slot] = r;
      }
      __syncthreads();    // the half's terms are in shared memory

      // write the half's timesteps below S: dB, dC over the warps in order
      const int ts = c * TCH + half * HALF;
      for (int i = tid; i < HALF * 2 * N; i += THREADS) {
        const int k = i / (2 * N), j = i % (2 * N);
        if (ts + k < s) {
          float acc = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) acc += sm.part[k][w][j];
          (j < N ? pb : pc)[(prow + ts + k) * N + j % N] = acc;
        }
      }
      for (int i = tid; i < HALF * CPB; i += THREADS) {
        const int k = i / CPB, j = i % CPB;
        if (ts + k < s && d0 + j < di) {
          ddt[(row + ts + k) * di + d0 + j] = sm.odt[k][j];
          dx[(row + ts + k) * di + d0 + j] = sm.odx[k][j];
        }
      }
      __syncthreads();    // before the next half overwrites them
    }
    load(c - 2, ci & 1, true);
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < SPL; ++i)
      pa[((int64_t)b * di + d) * N + SPL * sub + i] = da[i];
    if (sub == 0) pd[(int64_t)b * di + d] = dd;
  }
}

// out[i] = sum over k < K of in[k * M + i], in order of k
__global__ void sum_leading(const float* __restrict__ in,
                            float* __restrict__ out, int k_count,
                            int64_t m) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float acc = 0.f;
  for (int kk = 0; kk < k_count; ++kk) acc += in[kk * m + i];
  out[i] = acc;
}

cudaError_t sum_launch(const float* in, float* out, int k_count, int64_t m,
                       cudaStream_t stream) {
  if (m == 0) return cudaSuccess;
  sum_leading<<<(unsigned)((m + 255) / 256), 256, 0, stream>>>(in, out,
                                                               k_count, m);
  return cudaGetLastError();
}

// above 48 KB of shared memory only with the attribute; set once, before
// any graph capture
template <int N>
cudaError_t opt_in() {
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem<N>));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  return cudaSuccess;
}

template <int N>
cudaError_t occupancy(int* blocks) {
  cudaError_t err = opt_in<N>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, scan_bwd_kernel<N>, CPB * N / SPL, (int)sizeof(Smem<N>));
}

template <int N>
cudaError_t launch(const float* dt, const float* x, const float* bm,
                   const float* cm, const float* a, const float* dskip,
                   const float* dy, float* hs, float* pb, float* pc,
                   float* pa, float* pd, float* ddt, float* dx, float* db,
                   float* dc, float* da, float* dd, int bsz, int s, int di,
                   cudaStream_t stream) {
  constexpr int smem = (int)sizeof(Smem<N>);
  cudaError_t err = opt_in<N>();
  if (err != cudaSuccess) return err;
  const int blocks = (di + CPB - 1) / CPB;
  scan_bwd_kernel<N><<<dim3(blocks, bsz), CPB * N / SPL, smem, stream>>>(
      dt, x, bm, cm, a, dskip, dy, hs, ddt, dx, pb, pc, pa, pd, bsz, s, di);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t bsn = (int64_t)bsz * s * N;
  if ((err = sum_launch(pb, db, blocks, bsn, stream)) != cudaSuccess) return err;
  if ((err = sum_launch(pc, dc, blocks, bsn, stream)) != cudaSuccess) return err;
  if ((err = sum_launch(pa, da, bsz, (int64_t)di * N, stream)) != cudaSuccess)
    return err;
  return sum_launch(pd, dd, bsz, di, stream);
}

}  // namespace

// Scratch the caller allocates (f32): hs [B, ceil(S/32), di, N], pb and pc
// [ceil(di/32), B, S, N], pa [B, di, N], pd [B, di].  Five launches on the
// caller's stream, not synced; returns the first CUDA error (0 on success).
extern "C" int selective_scan_bwd_launch(
    const float* dt, const float* x, const float* bm, const float* cm,
    const float* a, const float* dskip, const float* dy, float* hs,
    float* pb, float* pc, float* pa, float* pd, float* ddt, float* dx,
    float* db, float* dc, float* da, float* dd, int64_t bsz, int64_t s,
    int64_t di, int64_t n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: return (int)launch<4>(dt, x, bm, cm, a, dskip, dy, hs, pb, pc, pa, pd, ddt, dx, db, dc, da, dd, (int)bsz, (int)s, (int)di, st);
    case 8: return (int)launch<8>(dt, x, bm, cm, a, dskip, dy, hs, pb, pc, pa, pd, ddt, dx, db, dc, da, dd, (int)bsz, (int)s, (int)di, st);
    case 16: return (int)launch<16>(dt, x, bm, cm, a, dskip, dy, hs, pb, pc, pa, pd, ddt, dx, db, dc, da, dd, (int)bsz, (int)s, (int)di, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Blocks of the backward kernel at state size n that fit on one SM of the
// current device, by its shared memory, registers and threads; -1 on an
// error.
extern "C" int selective_scan_bwd_blocks_per_sm(int64_t n) {
  int blocks = -1;
  cudaError_t err = cudaErrorInvalidValue;
  switch (n) {
    case 4: err = occupancy<4>(&blocks); break;
    case 8: err = occupancy<8>(&blocks); break;
    case 16: err = occupancy<16>(&blocks); break;
  }
  return err == cudaSuccess ? blocks : -1;
}
