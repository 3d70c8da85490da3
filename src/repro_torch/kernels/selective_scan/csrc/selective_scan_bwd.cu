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
// bytes.
//
// The design, simple and deterministic (no float atomics):
// - the forward's layout: a block is 32 channels of one batch row, each
//   channel's N states split over N/4 lanes of 4;
// - the forward saves nothing for it: pass 1 reruns the forward recurrence
//   and writes h at the start of every 16-step chunk to scratch, f32
//   [B, S/16, di, N];
// - pass 2 walks the chunks from the last: it recomputes the chunk's 16
//   states from the saved one into shared memory, then steps back through
//   them carrying e_{t+1} * lam_{t+1}, with the forward's operation order
//   for h;
// - sums over a channel's states run over a lane's 4 then a __shfl_xor
//   tree; dA and dD accumulate over time in registers and are written per
//   batch row; dB and dC are summed over the block's 32 channels in shared
//   memory in channel order and written per block of channels;
// - sum_leading adds those partials over batch rows (dA, dD) and channel
//   blocks (dB, dC) in index order.
// So two runs give the same bits.  Loads go straight to device memory, one
// timestep after another: the kernel is bound by their latency, far from
// the bound (staging chunks with cp.async, as the forward does, is the next
// lever).  expf, not __expf; no fast math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CPB = 32;         // channels per block
constexpr int TCH = 16;         // timesteps a chunk of the reverse pass
constexpr int SPL = 4;          // states per lane

template <int N>
constexpr size_t smem_bytes() {
  // states [TCH][threads][SPL], dB and dC partials [TCH][N][CPB]
  return sizeof(float) * (TCH * CPB * N + 2 * TCH * N * CPB);
}

template <int N>
__global__ void __launch_bounds__(CPB * N / SPL)
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
  extern __shared__ __align__(16) float smem[];
  float* hist = smem;                               // [TCH][THREADS][SPL]
  float* sb = hist + TCH * THREADS * SPL;           // [TCH][N][CPB]
  float* sc = sb + TCH * N * CPB;                   // [TCH][N][CPB]

  const int tid = threadIdx.x;
  const int ch = tid / LANES;                       // channel in the block
  const int sub = tid % LANES;                      // states SPL*sub ...
  const int b = blockIdx.y;
  const int d = blockIdx.x * CPB + ch;
  const bool live = d < di;
  const int64_t row = (int64_t)b * s;               // [b, 0] of [B, S, *]
  const int n_chunks = (s + TCH - 1) / TCH;

  float av[SPL], h[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) {
    av[i] = live ? a[(int64_t)d * N + SPL * sub + i] : 0.f;
    h[i] = 0.f;
  }
  const float dsk = live ? dskip[d] : 0.f;
  // the inputs of channel d at step t (zeros for a channel past di)
  auto chan = [&](const float* p, int t) {
    return live ? p[(row + t) * di + d] : 0.f;
  };
  auto saved = [&](int c) {        // h at the start of chunk c, this lane's
    return hs + (((int64_t)b * n_chunks + c) * di + d) * N + SPL * sub;
  };

  // pass 1: the forward recurrence, h saved at the start of each chunk
  for (int t = 0; t < s; ++t) {
    if (t % TCH == 0 && live)
#pragma unroll
      for (int i = 0; i < SPL; ++i) saved(t / TCH)[i] = h[i];
    const float dtv = chan(dt, t), xv = chan(x, t);
    const float u = dtv * xv;
    const float* bt = bm + (row + t) * N + SPL * sub;
#pragma unroll
    for (int i = 0; i < SPL; ++i) h[i] = expf(dtv * av[i]) * h[i] + u * bt[i];
  }

  // pass 2: the chunks in reverse
  float lam[SPL], da[SPL];
#pragma unroll
  for (int i = 0; i < SPL; ++i) lam[i] = da[i] = 0.f;
  float dd = 0.f;
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * TCH;
    const int tn = min(TCH, s - t0);
    float h0[SPL];
#pragma unroll
    for (int i = 0; i < SPL; ++i) {
      h0[i] = live ? saved(c)[i] : 0.f;
      h[i] = h0[i];
    }
    for (int tt = 0; tt < tn; ++tt) {
      const int t = t0 + tt;
      const float dtv = chan(dt, t), xv = chan(x, t);
      const float u = dtv * xv;
      const float* bt = bm + (row + t) * N + SPL * sub;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        h[i] = expf(dtv * av[i]) * h[i] + u * bt[i];
        hist[(tt * THREADS + tid) * SPL + i] = h[i];
      }
    }
    for (int tt = tn - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      const float g = chan(dy, t), dtv = chan(dt, t), xv = chan(x, t);
      const float u = dtv * xv;
      const float* bt = bm + (row + t) * N + SPL * sub;
      const float* ct = cm + (row + t) * N + SPL * sub;
      float part_dt = 0.f, part_u = 0.f;
#pragma unroll
      for (int i = 0; i < SPL; ++i) {
        const float hcur = hist[(tt * THREADS + tid) * SPL + i];
        const float hprev =
            tt > 0 ? hist[((tt - 1) * THREADS + tid) * SPL + i] : h0[i];
        const float e = expf(dtv * av[i]);
        const float lt = g * ct[i] + lam[i];
        sc[(tt * N + SPL * sub + i) * CPB + ch] = g * hcur;
        sb[(tt * N + SPL * sub + i) * CPB + ch] = lt * u;
        const float de = lt * hprev * e;            // dL/d(dt*A), state i
        part_dt += de * av[i];
        da[i] += de * dtv;
        part_u += lt * bt[i];
        lam[i] = e * lt;
      }
#pragma unroll
      for (int off = 1; off < LANES; off <<= 1) {
        part_dt += __shfl_xor_sync(0xffffffffu, part_dt, off);
        part_u += __shfl_xor_sync(0xffffffffu, part_u, off);
      }
      if (sub == 0 && live) {
        ddt[(row + t) * di + d] = part_dt + part_u * xv;
        dx[(row + t) * di + d] = part_u * dtv + g * dsk;
      }
      dd += g * xv;
    }
    __syncthreads();    // the chunk's dB and dC terms are in shared memory
    for (int i = tid; i < tn * N; i += THREADS) {
      const int tt = i / N, n = i % N;
      float accb = 0.f, accc = 0.f;
      for (int j = 0; j < CPB; ++j) {
        accb += sb[(tt * N + n) * CPB + j];
        accc += sc[(tt * N + n) * CPB + j];
      }
      const int64_t o = (((int64_t)blockIdx.x * bsz + b) * s + t0 + tt) * N + n;
      pb[o] = accb;
      pc[o] = accc;
    }
    __syncthreads();    // before the next chunk overwrites them
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

template <int N>
cudaError_t launch(const float* dt, const float* x, const float* bm,
                   const float* cm, const float* a, const float* dskip,
                   const float* dy, float* hs, float* pb, float* pc,
                   float* pa, float* pd, float* ddt, float* dx, float* db,
                   float* dc, float* da, float* dd, int bsz, int s, int di,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<N>();
  // above 48 KB only with the attribute; set once, before any graph capture
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const int blocks = (di + CPB - 1) / CPB;
  scan_bwd_kernel<N><<<dim3(blocks, bsz), CPB * N / SPL, smem, stream>>>(
      dt, x, bm, cm, a, dskip, dy, hs, ddt, dx, pb, pc, pa, pd, bsz, s, di);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t bsn = (int64_t)bsz * s * N;
  if ((err = sum_launch(pb, db, blocks, bsn, stream)) != cudaSuccess) return err;
  if ((err = sum_launch(pc, dc, blocks, bsn, stream)) != cudaSuccess) return err;
  if ((err = sum_launch(pa, da, bsz, (int64_t)di * N, stream)) != cudaSuccess)
    return err;
  return sum_launch(pd, dd, bsz, di, stream);
}

}  // namespace

// Scratch the caller allocates (f32): hs [B, ceil(S/16), di, N], pb and pc
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
