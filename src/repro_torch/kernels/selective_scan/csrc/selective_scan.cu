// Mamba-1 selective scan (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/selective_scan/scan.py::selective_scan_pallas (body
// _scan_kernel): for every (batch, channel d) the recurrence
//   h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * x_t) * B_t     (h in R^N)
//   y_t = C_t . h_t + D[d] * x_t
// over the whole sequence; dt/x f32[B,S,di], B/C f32[B,S,N], A f32[di,N],
// D f32[di] -> y f32[B,S,di].
//
// Bound on the card: at the main path's shape (falcon-mamba-7b prefill,
// [2, 2048, 8192], N=16) it must move dt, x and y (3 x 134 MB) and B, C
// (0.5 MB): 0.12 ms at 3.35 TB/s; and it takes B*S*di*N = 537M
// exponentials, 0.13 ms at the SFU rate of 16 per SM per clock (132 SMs at
// 1.98 GHz).  Both bounds are close; the recurrence is sequential in t.
//
// The design and what it does about that bound:
// - each channel's N states are split over N/4 lanes (4 lanes at N=16),
//   each holding 4 states of h and of A[d, :] in registers; a block is 32
//   channels (N/4 warps), so falcon's shape is 512 blocks of 128 threads,
//   about 16 warps per SM;
// - dt and x for 32 timesteps x 32 channels, and B and C for the same 32
//   timesteps, are staged in shared memory with cp.async, double-buffered:
//   the chunk after next is loaded while one is computed, so no timestep
//   waits on device memory;
// - a lane takes 8 timesteps a round: their 32 exponentials and 8 shuffle
//   trees are independent, so the scheduler can interleave them, while h
//   goes through the 8 steps in order (one step a round left the SM
//   waiting on each step's exp -> h -> y -> shuffle chain);
// - y_t = sum_n h_n C_n is summed over each lane's 4 states in order, then
//   across the lanes with a __shfl_xor tree; one lane a channel writes y_t
//   into a shared chunk, which the block stores coalesced once per chunk;
// - nothing of [B, S, di, N] ever reaches device memory.
// At falcon's width the kernel is bound by instruction issue: each state
// step is an accurate expf (8 instructions) and 3 more, about 66
// instructions a lane-step in all.
// Each h_n keeps the plain version's operation order, decay*h + (dt*x)*B,
// so h is what the plain version computes; only the order of y's N-term sum
// changes (4 lanes of 4 terms, then the tree), well inside the 2e-4
// tolerance of tests/test_kernels.py.  Ragged S and di are zero filled on
// load and never stored.  expf, not __expf; no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPB = 32;         // channels per block
constexpr int TCHUNK = 32;      // timesteps staged per chunk
constexpr int SPL = 4;          // states per lane
constexpr int ROUND = 8;        // timesteps a lane takes together

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 or 4 bytes global -> shared; when !ok, zeros are written and nothing
// is read (the source address must still be valid)
__device__ __forceinline__ void cp_async16(void* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

template <int N>
struct Stage {
  float dt[TCHUNK][CPB];
  float x[TCHUNK][CPB];
  float b[TCHUNK][N];
  float c[TCHUNK][N];
};

// U timesteps tt..tt+U-1 of one lane: every step is the plain version's
// arithmetic, in order for h; the U steps' exponentials and shuffle trees
// are independent, which gives the scheduler U chains to interleave.
template <int U, int N>
__device__ __forceinline__ void steps(const Stage<N>& sg, float (*ys)[CPB],
                                      int tt, int ch, int sub,
                                      const float (&av)[SPL],
                                      float (&h)[SPL], float dsk) {
  constexpr int LANES = N / SPL;
  float dtv[U], xv[U], e[U][SPL], acc[U];
  float4 bv[U], cv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    dtv[u] = sg.dt[tt + u][ch];
    xv[u] = sg.x[tt + u][ch];
    bv[u] = *reinterpret_cast<const float4*>(&sg.b[tt + u][SPL * sub]);
    cv[u] = *reinterpret_cast<const float4*>(&sg.c[tt + u][SPL * sub]);
#pragma unroll
    for (int i = 0; i < SPL; ++i) e[u][i] = expf(dtv[u] * av[i]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float dx = dtv[u] * xv[u];
    h[0] = e[u][0] * h[0] + dx * bv[u].x;
    h[1] = e[u][1] * h[1] + dx * bv[u].y;
    h[2] = e[u][2] * h[2] + dx * bv[u].z;
    h[3] = e[u][3] * h[3] + dx * bv[u].w;
    acc[u] = h[0] * cv[u].x;
    acc[u] += h[1] * cv[u].y;
    acc[u] += h[2] * cv[u].z;
    acc[u] += h[3] * cv[u].w;
  }
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1)
#pragma unroll
    for (int u = 0; u < U; ++u)
      acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
  if (sub == 0)
#pragma unroll
    for (int u = 0; u < U; ++u) ys[tt + u][ch] = acc[u] + xv[u] * dsk;
}

template <int N>
__global__ void __launch_bounds__(CPB * N / SPL)
scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
            const float* __restrict__ bm, const float* __restrict__ cm,
            const float* __restrict__ a, const float* __restrict__ dskip,
            float* __restrict__ y, int s, int di) {
  constexpr int LANES = N / SPL;                    // lanes a channel
  constexpr int THREADS = CPB * LANES;
  __shared__ __align__(16) Stage<N> stage[2];
  __shared__ float ys[TCHUNK][CPB];

  const int tid = threadIdx.x;
  const int ch = tid / LANES;                       // channel in the block
  const int sub = tid % LANES;                      // states SPL*sub ...
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CPB;
  const int d = d0 + ch;
  const bool live = d < di;
  // 16-byte copies where rows and bases allow them, else 4-byte copies
  const bool vec_dx = di % 4 == 0 && ((uintptr_t)dt | (uintptr_t)x) % 16 == 0;
  const bool vec_bc = ((uintptr_t)bm | (uintptr_t)cm) % 16 == 0;
  const int64_t row = (int64_t)b * s;               // [b, 0] of [B, S, *]

  float av[SPL], h[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    av[i] = live ? a[(int64_t)d * N + SPL * sub + i] : 0.f;
    h[i] = 0.f;
  }
  const float dsk = live ? dskip[d] : 0.f;

  // stage chunk `c` (timesteps TCHUNK*c ...) into buffer `buf`; always
  // commits a group, empty or not, so the wait below counts uniformly
  auto load = [&](int c, int buf) {
    const int t0 = c * TCHUNK;
    if (t0 < s) {
      Stage<N>& sg = stage[buf];
      if (vec_dx) {
        for (int i = tid; i < TCHUNK * CPB / 4; i += THREADS) {
          const int tt = i / (CPB / 4), j = 4 * (i % (CPB / 4));
          const bool ok = t0 + tt < s && d0 + j < di;
          const int64_t off = ok ? (row + t0 + tt) * di + d0 + j : 0;
          cp_async16(&sg.dt[tt][j], dt + off, ok);
          cp_async16(&sg.x[tt][j], x + off, ok);
        }
      } else {
        for (int i = tid; i < TCHUNK * CPB; i += THREADS) {
          const int tt = i / CPB, j = i % CPB;
          const bool ok = t0 + tt < s && d0 + j < di;
          const int64_t off = ok ? (row + t0 + tt) * di + d0 + j : 0;
          cp_async4(&sg.dt[tt][j], dt + off, ok);
          cp_async4(&sg.x[tt][j], x + off, ok);
        }
      }
      const int64_t bc0 = (row + t0) * N;
      if (vec_bc) {
        for (int i = 4 * tid; i < TCHUNK * N; i += 4 * THREADS) {
          const bool ok = t0 + i / N < s;
          cp_async16(&sg.b[0][i], bm + (ok ? bc0 + i : 0), ok);
          cp_async16(&sg.c[0][i], cm + (ok ? bc0 + i : 0), ok);
        }
      } else {
        for (int i = tid; i < TCHUNK * N; i += THREADS) {
          const bool ok = t0 + i / N < s;
          cp_async4(&sg.b[0][i], bm + (ok ? bc0 + i : 0), ok);
          cp_async4(&sg.c[0][i], cm + (ok ? bc0 + i : 0), ok);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  const int n_chunks = (s + TCHUNK - 1) / TCHUNK;
  load(0, 0);
  load(1, 1);
  for (int c = 0; c < n_chunks; ++c) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // chunk c landed
    __syncthreads();
    const Stage<N>& sg = stage[c & 1];
    const int tn = min(TCHUNK, s - c * TCHUNK);
    int tt = 0;
    for (; tt + ROUND <= tn; tt += ROUND)
      steps<ROUND>(sg, ys, tt, ch, sub, av, h, dsk);
    for (; tt < tn; ++tt) steps<1>(sg, ys, tt, ch, sub, av, h, dsk);
    __syncthreads();    // chunk c's stage and ys are complete
    load(c + 2, c & 1);
    const int64_t t0 = c * TCHUNK;
    for (int i = tid; i < tn * CPB; i += THREADS) {
      const int tt = i / CPB, j = i % CPB;
      if (d0 + j < di) y[(row + t0 + tt) * di + d0 + j] = ys[tt][j];
    }
  }
}

template <int N>
cudaError_t launch(const float* dt, const float* x, const float* bm,
                   const float* cm, const float* a, const float* dskip,
                   float* y, int bsz, int s, int di, cudaStream_t stream) {
  dim3 grid((di + CPB - 1) / CPB, bsz);
  scan_kernel<N><<<grid, CPB * N / SPL, 0, stream>>>(dt, x, bm, cm, a,
                                                     dskip, y, s, di);
  return cudaGetLastError();
}

}  // namespace

// Returns the CUDA error of the launch (0 on success); the caller's stream
// is not synced.
extern "C" int selective_scan_launch(const float* dt, const float* x,
                                     const float* bm, const float* cm,
                                     const float* a, const float* dskip,
                                     float* y, int64_t bsz, int64_t s,
                                     int64_t di, int64_t n, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 4: return (int)launch<4>(dt, x, bm, cm, a, dskip, y, (int)bsz, (int)s, (int)di, st);
    case 8: return (int)launch<8>(dt, x, bm, cm, a, dskip, y, (int)bsz, (int)s, (int)di, st);
    case 16: return (int)launch<16>(dt, x, bm, cm, a, dskip, y, (int)bsz, (int)s, (int)di, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
