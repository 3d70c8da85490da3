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
// The simple design and what it does about that bound:
// - one thread per (b, d) channel, its state h[N] and A[d, :] in registers
//   (N is a template parameter: 4, 8 or 16), walking t = 0..S-1;
// - loads of dt and x and stores of y are coalesced across d;
// - B[b, t, :] and C[b, t, :] are the same for the whole block, so a chunk
//   of 64 timesteps of both is staged in shared memory;
// - nothing of [B, S, di, N] ever reaches device memory.
// At falcon's shapes B*di = 16,384 threads are about one wave of 128-thread
// blocks on 132 SMs: one warp per SM, so the loop is latency bound (low
// occupancy).  Splitting the sequence into chunks with a second pass that
// carries the state across them is later work.
// The plain version's order is kept: decay*h + (dt*x)*B, then
// sum_n h*C + x*D.  expf, not __expf; no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;    // channels per block
constexpr int TCHUNK = 64;      // timesteps of B and C staged per pass

template <int N>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const float* __restrict__ dt, const float* __restrict__ x,
            const float* __restrict__ bm, const float* __restrict__ cm,
            const float* __restrict__ a, const float* __restrict__ dskip,
            float* __restrict__ y, int s, int di) {
  __shared__ float bs[TCHUNK * N];
  __shared__ float cs[TCHUNK * N];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool live = d < di;

  float av[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    av[n] = live ? a[(int64_t)d * N + n] : 0.f;
    h[n] = 0.f;
  }
  const float dsk = live ? dskip[d] : 0.f;
  const int64_t row = (int64_t)b * s;               // [b, 0] of [B, S, *]
  const float* bb = bm + row * N;
  const float* cb = cm + row * N;

  for (int t0 = 0; t0 < s; t0 += TCHUNK) {
    const int tn = min(TCHUNK, s - t0);
    __syncthreads();    // the previous chunk's B and C are consumed
    for (int i = threadIdx.x; i < tn * N; i += THREADS) {
      bs[i] = bb[(int64_t)t0 * N + i];
      cs[i] = cb[(int64_t)t0 * N + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < tn; ++tt) {
      const int64_t off = (row + t0 + tt) * di + d;
      const float dtv = dt[off];
      const float xv = x[off];
      const float dx = dtv * xv;
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtv * av[n]) * h[n] + dx * bs[tt * N + n];
        acc += h[n] * cs[tt * N + n];
      }
      y[off] = acc + xv * dsk;
    }
  }
}

template <int N>
cudaError_t launch(const float* dt, const float* x, const float* bm,
                   const float* cm, const float* a, const float* dskip,
                   float* y, int bsz, int s, int di, cudaStream_t stream) {
  dim3 grid((di + THREADS - 1) / THREADS, bsz);
  scan_kernel<N><<<grid, THREADS, 0, stream>>>(dt, x, bm, cm, a, dskip, y,
                                               s, di);
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
