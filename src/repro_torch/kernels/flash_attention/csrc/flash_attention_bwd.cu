// Causal GQA flash attention, backward, for Hopper (sm_90a).
//
// No TPU counterpart: the Pallas kernel
// src/repro/kernels/flash_attention/flash.py::flash_attention is forward
// only, and JAX trains through the jnp online softmax
// (src/repro/models/attention.py::flash_attention_ref), which XLA
// differentiates.  This is the gradient of the port's forward
// (flash_attention.cu): from q, k, v [B,S,heads,hd], the output o, its
// gradient dO and the forward's per-row log-sum-exp (f32 [B,H,Sq], scaled
// scores) it computes dq, dk, dv in q's dtype, every sum in f32.  Query head
// h reads KV head h / (H/KH); causal mask, optional sliding window
// (key > query - window), Sq <= Skv with queries starting at key 0.
//
// Bound on the card: at qwen3-0.6b's training shape ([4, 2048, 16/8, 128]
// bf16, causal) the four products of the backward and the recomputed
// scores are 2.5x the forward's 68.7 GFLOP, 172 GFLOP: 0.17 ms at the 989
// TFLOP/s bf16 tensor-core peak, against 67 MB of q/k/v/o/dO/dq/dk/dv,
// 0.02 ms at 3.35 TB/s: bound by operations.  The deterministic structure
// below (no float atomics) recomputes S and dP in both passes: seven
// 64x64xhd products per visible pair of tiles, 240 GFLOP at that shape.
//
// Both designs share the structure, which is deterministic:
// - delta_kernel: delta = rowsum(dO * O) in f32, one warp a row;
// - dK/dV: one block per (key tile, KV head, batch) keeps its K and V
//   tiles and loops over the G query heads of its group, then over the
//   query tiles that see any of its keys, in that fixed order; for each it
//   recomputes S^T = K Q^T (scaled), P^T = exp(S^T - lse) (0 where masked),
//   dP^T = V dO^T and dS^T = P^T (dP^T - delta), and adds P^T dO into dv
//   and dS^T Q into dk, both in registers;
// - dQ: one block per (query tile, head, batch) loops over the key tiles
//   its rows see, recomputes P and dS the same way and adds dS K into dq
//   in registers.
// Nothing is summed across blocks, so two runs give the same bits.
//
// wgmma-bf16, bf16 (dkdv_wgmma_kernel, dq_wgmma_kernel): tensor cores.
// - a dK/dV block is two warpgroups, each owning 64 keys (wgmma's M) of a
//   128-key tile, with dK and dV [64 x hd] as f32 accumulators; Q and dO
//   tiles of 64 queries (and their 64 lse and delta values) run through a
//   2-stage cp.async ring that both warpgroups read, so the next tiles'
//   loads are in flight while one is computed;
// - a dQ block is two warpgroups of 64 query rows with dQ in registers;
//   Q and dO are staged once, K and V tiles of 64 keys run through the
//   ring, and the grid runs the query tiles heaviest first (the last tile
//   of a causal sequence sees the most keys), as the forward does; the
//   dK/dV grid runs key tile 0, which the most queries see, first;
// - every tile is 128-byte swizzled bf16 (hd zero padded to 64 or 128), as
//   the forward stages them (hopper::load_tile).  One staged tile serves
//   two products: S^T = K Q^T reads Q K-major (its rows are the N of the
//   product, hd the K), dK += dS^T Q reads the same tile MN-major through
//   the transpose bit (queries the K, hd the N): two descriptors of one
//   tile.  Likewise dO for dP^T and dV, and K for S and dQ;
// - S^T and dP^T are wgmma m64n64k16 with both operands in shared memory,
//   issued as two commit groups: the exponentials of P^T run while dP^T is
//   still in the tensor cores.  In this transposed orientation lse and
//   delta are per column, read from the ring at the accumulator's columns;
// - P^T and dS^T are rounded to bf16 in registers and are the register A
//   operands of wgmma m64n{64,128}k16 for dV and dK, as the forward rounds
//   P for P.V (FlashAttention's rounding); the dQ kernel does the same
//   with dS for dS.K;
// - tiles that hold no visible pair are skipped: per block in dK/dV (a
//   warpgroup whose 64 keys see none of a tile runs it masked, as a branch
//   on the warpgroup makes ptxas serialize that kernel's wgmma), per
//   warpgroup in dQ; masks run only on tiles that straddle the diagonal,
//   the window or an edge;
// - dQ and dK are scaled by 1/sqrt(hd) in f32 before the store, and only
//   the first hd columns are stored;
// - the kernels make no call (expf is inline; there is no division): ptxas
//   serializes every wgmma of a kernel that does.
// fma-tiles, f32 (dkdv_kernel, dq_kernel): one block of 256 threads per
// 64-key or 64-query tile, every product an f32 FMA on tiles staged in
// shared memory, bound by the FMA pipes (67 TFLOP/s); f32 products keep
// the 1e-4 atol that TF32 tensor cores would not.
// expf, not __expf; no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int THREADS = 256;    // a 16 x 16 grid of (row group, column group)
constexpr int PLD = 65;         // row pitch of the 64 x 64 P and dS tiles

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }

// rows [row0, row0 + R) of one head, [R][HD] at `row_stride` elements apart,
// into f32 shared memory [R][LD]; rows past `rows` are zeros
template <typename T, int HD, int LD, int R>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int row0,
                                          int rows, int tid) {
  for (int i = tid; i < R * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    dst[r * LD + d] =
        row0 + r < rows ? ld(src + (int64_t)(row0 + r) * row_stride + d) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int sq, int skv,
                                        int causal, int window) {
  bool ok = qpos < sq && kpos < skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d], one warp a row
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o,
                             const T* __restrict__ dout,
                             float* __restrict__ delta, int64_t rows, int sq,
                             int h, int hd) {
  const int64_t row = (int64_t)blockIdx.x * (blockDim.x / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const T* op = o + row * hd;
  const T* dp = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(ld(dp + d), ld(op + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    // row = (b * sq + i) * h + head
    const int64_t b = row / ((int64_t)sq * h);
    const int i = (int)((row / h) % sq), head = (int)(row % h);
    delta[(b * h + head) * sq + i] = acc;
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  // four [64][HD+4] f32 tiles, the P and dS tiles, lse and delta
  return sizeof(float) * (4 * 64 * (HD + 4) + 2 * 64 * PLD + 2 * 64);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            T* __restrict__ dk, T* __restrict__ dv, int sq, int skv, int h,
            int kh, int causal, int window, float scale) {
  constexpr int LD = HD + 4;      // padded row: conflict-free float4 reads
  constexpr int CPT = HD / 16;    // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // [BK][LD]
  float* vs = ks + BK * LD;       // [BK][LD]
  float* qs = vs + BK * LD;       // [BQ][LD]
  float* dos = qs + BQ * LD;      // [BQ][LD]
  float* ps = dos + BQ * LD;      // [BK][PLD]: P^T, key-major
  float* dss = ps + BK * PLD;     // [BK][PLD]: dS^T
  float* ls = dss + BK * PLD;     // [BQ]
  float* dls = ls + BQ;           // [BQ]

  const int tid = threadIdx.x;
  const int tr = tid >> 4;        // key rows tr + 16*i
  const int tc = tid & 15;        // query columns tc + 16*j, hd tc + 16*c
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / kh;
  const int64_t q_stride = (int64_t)h * HD;
  const int64_t kv_stride = (int64_t)kh * HD;
  const int64_t kv_off = ((int64_t)b * skv * kh + kvh) * HD;

  load_tile<T, HD, LD, BK>(ks, k + kv_off, kv_stride, k0, skv, tid);
  load_tile<T, HD, LD, BK>(vs, v + kv_off, kv_stride, k0, skv, tid);

  float dka[4][CPT], dva[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dka[i][c] = dva[i][c] = 0.f;

  // the query tiles that see a key of this tile
  const int k_last = min(k0 + BK, skv) - 1;
  const int qt_lo = causal ? k0 / BQ : 0;
  const int q_hi = window > 0 ? min(sq, k_last + window) : sq;
  const int qt_hi = (q_hi + BQ - 1) / BQ;

  for (int gi = 0; gi < g; ++gi) {
    const int head = kvh * g + gi;
    const int64_t q_off = ((int64_t)b * sq * h + head) * HD;
    const float* lb = lse + ((int64_t)b * h + head) * sq;
    const float* db = delta + ((int64_t)b * h + head) * sq;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();    // the previous tile's Q, dO, P, dS are consumed
      load_tile<T, HD, LD, BQ>(qs, q + q_off, q_stride, q0, sq, tid);
      load_tile<T, HD, LD, BQ>(dos, dout + q_off, q_stride, q0, sq, tid);
      if (tid < BQ) {
        ls[tid] = q0 + tid < sq ? lb[q0 + tid] : 0.f;
        dls[tid] = q0 + tid < sq ? db[q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T and dP^T: key rows tr + 16i, query columns tc + 16j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 kv[4], vv[4], qv[4], dv4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = *reinterpret_cast<const float4*>(&ks[(tr + 16 * i) * LD + d]);
          vv[i] = *reinterpret_cast<const float4*>(&vs[(tr + 16 * i) * LD + d]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = *reinterpret_cast<const float4*>(&qs[(tc + 16 * j) * LD + d]);
          dv4[j] =
              *reinterpret_cast<const float4*>(&dos[(tc + 16 * j) * LD + d]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = dot4(kv[i], qv[j], s[i][j]);
            dp[i][j] = dot4(vv[i], dv4[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tr + 16 * i, c = tc + 16 * j;
          float p = 0.f;
          if (visible(q0 + c, k0 + r, sq, skv, causal, window))
            p = expf(s[i][j] * scale - ls[c]);
          ps[r * PLD + c] = p;
          dss[r * PLD + c] = p * (dp[i][j] - dls[c]);
        }
      __syncthreads();

      // dv += P^T dO, dk += dS^T Q (scaled at the end)
#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pr[4], dr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = ps[(tr + 16 * i) * PLD + c];
          dr[i] = dss[(tr + 16 * i) * PLD + c];
        }
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          const float dov = dos[c * LD + tc + 16 * cc];
          const float qv = qs[c * LD + tc + 16 * cc];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][cc] = fmaf(pr[i], dov, dva[i][cc]);
            dka[i][cc] = fmaf(dr[i], qv, dka[i][cc]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + tr + 16 * i;
    if (kpos >= skv) continue;
    const int64_t row = kv_off + (int64_t)kpos * kv_stride;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      st(&dk[row + tc + 16 * cc], dka[i][cc] * scale);
      st(&dv[row + tc + 16 * cc], dva[i][cc]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, int sq, int skv, int h, int kh, int causal,
          int window, float scale) {
  constexpr int LD = HD + 4;
  constexpr int CPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [BQ][LD]
  float* dos = qs + BQ * LD;      // [BQ][LD]
  float* ks = dos + BQ * LD;      // [BK][LD]
  float* vs = ks + BK * LD;       // [BK][LD]
  float* dss = vs + BK * LD;      // [BQ][PLD]: dS, query-major
  float* ls = dss + 2 * BQ * PLD; // [BQ] (after the unused P-sized gap)
  float* dls = ls + BQ;           // [BQ]

  const int tid = threadIdx.x;
  const int tr = tid >> 4;        // query rows tr + 16*i
  const int tc = tid & 15;        // key columns tc + 16*j, hd tc + 16*c
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / kh);
  const int64_t q_stride = (int64_t)h * HD;
  const int64_t kv_stride = (int64_t)kh * HD;
  const int64_t q_off = ((int64_t)b * sq * h + head) * HD;
  const int64_t kv_off = ((int64_t)b * skv * kh + kvh) * HD;
  const float* lb = lse + ((int64_t)b * h + head) * sq;
  const float* db = delta + ((int64_t)b * h + head) * sq;

  load_tile<T, HD, LD, BQ>(qs, q + q_off, q_stride, q0, sq, tid);
  load_tile<T, HD, LD, BQ>(dos, dout + q_off, q_stride, q0, sq, tid);
  if (tid < BQ) {
    ls[tid] = q0 + tid < sq ? lb[q0 + tid] : 0.f;
    dls[tid] = q0 + tid < sq ? db[q0 + tid] : 0.f;
  }

  // the key tiles that hold a key some row of this tile sees
  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_hi = causal ? min(skv, q_last + 1) : skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_lo = k_lo / BK;
  const int kt_hi = (k_hi + BK - 1) / BK;

  float dqa[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dqa[i][c] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();      // the previous tile's K, V, dS are consumed
    load_tile<T, HD, LD, BK>(ks, k + kv_off, kv_stride, k0, skv, tid);
    load_tile<T, HD, LD, BK>(vs, v + kv_off, kv_stride, k0, skv, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], dv4[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = *reinterpret_cast<const float4*>(&qs[(tr + 16 * i) * LD + d]);
        dv4[i] = *reinterpret_cast<const float4*>(&dos[(tr + 16 * i) * LD + d]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tc + 16 * j) * LD + d]);
        vv[j] = *reinterpret_cast<const float4*>(&vs[(tc + 16 * j) * LD + d]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = dot4(qv[i], kv[j], s[i][j]);
          dp[i][j] = dot4(dv4[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tr + 16 * i, c = tc + 16 * j;
        float ds = 0.f;
        if (visible(q0 + r, k0 + c, sq, skv, causal, window)) {
          const float p = expf(s[i][j] * scale - ls[r]);
          ds = p * (dp[i][j] - dls[r]);
        }
        dss[r * PLD + c] = ds;
      }
    __syncthreads();

    // dq += dS K (scaled at the end)
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = dss[(tr + 16 * i) * PLD + c];
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float kv = ks[c * LD + tc + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[i][cc] = fmaf(dr[i], kv, dqa[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + tr + 16 * i;
    if (qpos >= sq) continue;
    const int64_t row = q_off + (int64_t)qpos * q_stride;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc)
      st(&dq[row + tc + 16 * cc], dqa[i][cc] * scale);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int b, int sq,
                   int skv, int h, int kh, int causal, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // above 48 KB only with the attribute; set once, before any graph capture
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t rows = (int64_t)b * sq * h;
  delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, rows, sq, h, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)HD);
  dkdv_kernel<T, HD><<<dim3((skv + BK - 1) / BK, kh, b), THREADS, smem,
                       stream>>>(qt, kt, vt, dot, lse, delta,
                                 static_cast<T*>(dk), static_cast<T*>(dv),
                                 sq, skv, h, kh, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<T, HD><<<dim3((sq + BQ - 1) / BQ, h, b), THREADS, smem,
                     stream>>>(qt, kt, vt, dot, lse, delta,
                               static_cast<T*>(dq), sq, skv, h, kh, causal,
                               window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, void* dk, void* dv, int b,
                      int sq, int skv, int h, int kh, int causal, int window,
                      cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kh, causal, window, s);
    case 32: return launch<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kh, causal, window, s);
    case 64: return launch<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kh, causal, window, s);
    case 80: return launch<T, 80>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kh, causal, window, s);
    case 128: return launch<T, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kh, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16 on tensor cores

namespace tc {

constexpr int BT = 64;          // rows of a ring tile (queries or keys)
constexpr int BB = 128;         // rows a block owns: two warpgroups of 64
constexpr int STAGES = 2;       // ring: tile it+1 in flight
constexpr int THREADS = 256;

template <int HD>
struct Tile {
  static constexpr int HDP = HD <= 64 ? 64 : 128;   // hd padded to atoms
  static constexpr int BIG = BB * HDP * 2;          // a block's own tile
  static constexpr int SMALL = BT * HDP * 2;        // one ring tile
  static constexpr int KSTEPS = (HD + 15) / 16;     // hd steps holding data
  // two own tiles, two rings of tiles, (dK/dV) the lse and delta rings,
  // and slack to align to 1024 bytes
  static constexpr int SMEM = 2 * BIG + 2 * STAGES * SMALL +
                              2 * STAGES * BT * 4 + 1024;
};

template <int HD, int R>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int row0,
                                          int rows, int tid) {
  hopper::load_tile<HD, Tile<HD>::HDP, R, THREADS>(dst, src, row_stride,
                                                   row0, rows, tid);
}

// D[64 x 64] = A B^T over the first KSTEPS*16 hd columns: A is this
// warpgroup's 64 rows of a swizzled tile of `a_rows` rows, B a 64-row ring
// tile, both K-major (hd contiguous), so nothing is transposed.  One
// commit group.
template <int HD>
__device__ __forceinline__ void product_kmajor(float (&d)[32], uint32_t a,
                                               int a_rows, int wg,
                                               uint32_t b) {
  hopper::zero(d);
  hopper::fence_regs(d);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Tile<HD>::KSTEPS; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    hopper::wgmma_ss_m64n64k16(
        d, hopper::desc128(a + (kk / 4) * a_rows * 128 + wg * 64 * 128 + off,
                           16, 1024),
        hopper::desc128(b + (kk / 4) * BT * 128 + off, 16, 1024));
  }
  hopper::wgmma_commit();
}

// D[64 x HDP] += A B: A the bf16 register fragments of a 64-column
// accumulator (the product's K), B a 64-row ring tile read MN-major (its
// rows the K, hd the N; the transpose bit).  Issued, not committed.
template <int HDP>
__device__ __forceinline__ void product_mnmajor(float (&d)[HDP / 2],
                                                const uint32_t (&a)[4][4],
                                                uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    const uint64_t db = hopper::desc128(b + kk * 16 * 128, BT * 128, 1024);
    if constexpr (HDP == 64) hopper::wgmma_rs_m64n64k16(d, a[kk], db);
    else hopper::wgmma_rs_m64n128k16(d, a[kk], db);
  }
}

// rows r0 and r0 + 8 of a [rows, heads, HD] bf16 tensor from an f32
// accumulator (wgmma's D layout: d[4j + e] is row r0 + 8*(e >> 1), column
// 8j + c0 + (e & 1)), times `mul`; rows at or past `rows` and columns past
// HD are not stored
template <int HD, int HDP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           int64_t row_stride, int r0,
                                           int c0, int rows,
                                           const float (&d)[HDP / 2],
                                           float mul) {
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + c0;
    if (col >= HD) continue;
    if (r0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(&base[(int64_t)r0 * row_stride +
                                               col]) =
          __floats2bfloat162_rn(d[4 * j] * mul, d[4 * j + 1] * mul);
    if (r0 + 8 < rows)
      *reinterpret_cast<__nv_bfloat162*>(
          &base[(int64_t)(r0 + 8) * row_stride + col]) =
          __floats2bfloat162_rn(d[4 * j + 2] * mul, d[4 * j + 3] * mul);
  }
}

// dK/dV's item `it` (head head0 + it/nq, query tile qt_lo + it%nq) into
// ring stage st: its Q and dO tiles and its 64 lse and delta values (lse
// ring [STAGES][64] at `lring`, then the delta ring; zeros past Sq)
template <int HD>
__device__ __forceinline__ void stage_item(
    uint32_t qs, uint32_t dos, uint32_t lring, const __nv_bfloat16* q,
    const __nv_bfloat16* dout, const float* lse, const float* delta, int it,
    int st, int head0, int nq, int qt_lo, int b, int sq, int h, int tid) {
  const int head = head0 + it / nq;
  const int q0 = (qt_lo + it % nq) * BT;
  const int64_t q_stride = (int64_t)h * HD;
  const int64_t q_off = ((int64_t)b * sq * h + head) * HD;
  load_tile<HD, BT>(qs + st * Tile<HD>::SMALL, q + q_off, q_stride, q0, sq,
                    tid);
  load_tile<HD, BT>(dos + st * Tile<HD>::SMALL, dout + q_off, q_stride, q0,
                    sq, tid);
  if (tid < 2 * BT) {
    const int r = tid % BT;
    const float* src = (tid < BT ? lse : delta) + ((int64_t)b * h + head) * sq;
    const bool ok = q0 + r < sq;
    hopper::cp_async4(lring + ((tid / BT) * STAGES + st) * BT * 4 + r * 4,
                      ok ? src + q0 + r : src, ok ? 4 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, int bsz, int sq, int skv,
                  int h, int kh, int causal, int window, float scale) {
  using T = Tile<HD>;
  constexpr int HDP = T::HDP;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ks = (raw + 1023) & ~1023u;        // K [128 keys]
  const uint32_t vs = ks + T::BIG;                  // V [128 keys]
  const uint32_t qs = vs + T::BIG;                  // Q ring
  const uint32_t dos = qs + STAGES * T::SMALL;      // dO ring
  // lse ring [STAGES][64], then the delta ring
  float* lring = reinterpret_cast<float*>(
      smem_raw + (dos + STAGES * T::SMALL - raw));
  const uint32_t lring_s = dos + STAGES * T::SMALL;

  const int tid = threadIdx.x;
  const int wg = tid / 128;                         // keys 64*wg of the tile
  const int warp = (tid % 128) / 32;                // rows 16*warp of those
  const int lane = tid % 32;
  // key tile 0, which the most queries see, first
  const int kt = (int)(blockIdx.x / (bsz * kh));
  const int kvh = blockIdx.x % kh;
  const int b = (blockIdx.x / kh) % bsz;
  const int k0 = kt * BB;
  const int g = h / kh;

  const int64_t kv_stride = (int64_t)kh * HD;       // between key rows
  const int64_t kv_off = ((int64_t)b * skv * kh + kvh) * HD;

  // the query tiles that see a key of this block, for each of the G heads
  const int k_last = min(k0 + BB, skv) - 1;
  const int qt_lo = causal ? k0 / BT : 0;
  const int q_hi = window > 0 ? min(sq, k_last + window) : sq;
  const int nq = max((q_hi + BT - 1) / BT - qt_lo, 0);
  const int n_items = g * nq;
  const int wk0 = k0 + 64 * wg;                     // this warpgroup's keys

  // K and V with the first item, then one commit group an item
  load_tile<HD, BB>(ks, k + kv_off, kv_stride, k0, skv, tid);
  load_tile<HD, BB>(vs, v + kv_off, kv_stride, k0, skv, tid);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_items)
      stage_item<HD>(qs, dos, lring_s, q, dout, lse, delta, i, i, kvh * g,
                     nq, qt_lo, b, sq, h, tid);
    hopper::cp_async_commit();
  }

  // this thread's accumulator rows (keys) and first column
  const int r0 = wk0 + 16 * warp + lane / 4;        // and r0 + 8
  const int c0 = 2 * (lane % 4);
  float dka[HDP / 2], dva[HDP / 2];
  hopper::zero(dka);
  hopper::zero(dva);

  for (int it = 0; it < n_items; ++it) {
    const int st = it % STAGES;
    if (it + STAGES - 1 < n_items)
      stage_item<HD>(qs, dos, lring_s, q, dout, lse, delta, it + STAGES - 1,
                     (it + STAGES - 1) % STAGES, kvh * g, nq, qt_lo, b, sq, h,
                     tid);
    hopper::cp_async_commit();
    hopper::cp_async_wait<STAGES - 1>();  // item it (and K, V) has landed
    hopper::fence_proxy_async();
    __syncthreads();

    // every item has a visible pair for some key of the block; a
    // warpgroup whose keys see none of it runs it masked to zeros (a
    // branch on the warpgroup would make ptxas serialize the wgmma)
    const int q0 = (qt_lo + it % nq) * BT;
    {
      const uint32_t qt = qs + st * T::SMALL, dot = dos + st * T::SMALL;
      // S^T = K Q^T, then dP^T = V dO^T: two commit groups
      float s[32], dp[32];
      product_kmajor<HD>(s, ks, BB, wg, qt);
      product_kmajor<HD>(dp, vs, BB, wg, dot);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);

      // P^T; s[4j + e] is key r0 + 8*(e >> 1), query q0 + 8j + c0 + (e & 1)
      const float* ls = lring + st * BT;
      const float* dl = lring + (STAGES + st) * BT;
      const bool edge = q0 + BT > sq || wk0 + 64 > skv ||
                        (causal && wk0 + 63 > q0) ||
                        (window > 0 && wk0 <= q0 + BT - 1 - window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + c0 + (i & 1);
        float p = expf(s[i] * scale - ls[col]);
        if (edge && !visible(q0 + col, r0 + 8 * ((i >> 1) & 1), sq, skv,
                             causal, window))
          p = 0.f;
        s[i] = p;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i >> 2) + c0 + (i & 1);
        dp[i] = s[i] * (dp[i] - dl[col]);
      }

      // dV += P^T dO, dK += dS^T Q: P^T and dS^T in bf16 as register A
      // operands, dO and Q read MN-major from the ring
      uint32_t pa[4][4], da[4][4];
      hopper::to_a_frags(s, pa);
      hopper::to_a_frags(dp, da);
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
      hopper::wgmma_fence();
      product_mnmajor<HDP>(dva, pa, dot);
      product_mnmajor<HDP>(dka, da, qt);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dva);
      hopper::fence_regs(dka);
      hopper::fence_regs(pa);
      hopper::fence_regs(da);
    }
    __syncthreads();    // stage st is consumed before it is loaded again
  }
  hopper::cp_async_wait<0>();     // no copy outlives the block (no items)

  if (wk0 >= skv) return;
  store_rows<HD, HDP>(dk + kv_off, kv_stride, r0, c0, skv, dka, scale);
  store_rows<HD, HDP>(dv + kv_off, kv_stride, r0, c0, skv, dva, 1.f);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                __nv_bfloat16* __restrict__ dq, int bsz, int sq, int skv,
                int h, int kh, int causal, int window, float scale) {
  using T = Tile<HD>;
  constexpr int HDP = T::HDP;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t qs = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t dos = qs + T::BIG;                 // dO [128 rows]
  const uint32_t ks = dos + T::BIG;                 // K ring
  const uint32_t vs = ks + STAGES * T::SMALL;       // V ring

  const int tid = threadIdx.x;
  const int wg = tid / 128;                         // rows 64*wg
  const int warp = (tid % 128) / 32;                // rows 16*warp of those
  const int lane = tid % 32;
  // heaviest query tile first: the tile index runs down as blockIdx.x runs up
  const int n_qt = (sq + BB - 1) / BB;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (bsz * h));
  const int head = blockIdx.x % h;
  const int b = (blockIdx.x / h) % bsz;
  const int kvh = head / (h / kh);
  const int q0 = qt * BB;

  const int64_t q_stride = (int64_t)h * HD;
  const int64_t kv_stride = (int64_t)kh * HD;
  const int64_t q_off = ((int64_t)b * sq * h + head) * HD;
  const __nv_bfloat16* kb = k + ((int64_t)b * skv * kh + kvh) * HD;
  const __nv_bfloat16* vb = v + ((int64_t)b * skv * kh + kvh) * HD;

  // key tiles that hold a visible key for some row of the block ...
  const int q_last = min(q0 + BB, sq) - 1;
  const int kt_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / BT;
  const int kt_hi = ((causal ? min(skv, q_last + 1) : skv) + BT - 1) / BT;
  // ... and for some row of this warpgroup (none if its rows are past Sq)
  const int wq0 = q0 + 64 * wg;
  const int wq_last = min(wq0 + 64, sq) - 1;
  const int wk_lo = window > 0 ? max(0, wq0 - window + 1) : 0;
  const int wk_hi = causal ? min(skv, wq_last + 1) : skv;

  // Q and dO with the first tile, then one commit group a tile
  load_tile<HD, BB>(qs, q + q_off, q_stride, q0, sq, tid);
  load_tile<HD, BB>(dos, dout + q_off, q_stride, q0, sq, tid);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (kt_lo + i < kt_hi) {
      load_tile<HD, BT>(ks + i * T::SMALL, kb, kv_stride, (kt_lo + i) * BT,
                        skv, tid);
      load_tile<HD, BT>(vs + i * T::SMALL, vb, kv_stride, (kt_lo + i) * BT,
                        skv, tid);
    }
    hopper::cp_async_commit();
  }

  // this thread's accumulator rows (queries), their lse and delta
  const int r0 = wq0 + 16 * warp + lane / 4;        // and r0 + 8
  const int c0 = 2 * (lane % 4);
  const float* lb = lse + ((int64_t)b * h + head) * sq;
  const float* db = delta + ((int64_t)b * h + head) * sq;
  const float l0 = r0 < sq ? lb[r0] : 0.f, l1 = r0 + 8 < sq ? lb[r0 + 8] : 0.f;
  const float e0 = r0 < sq ? db[r0] : 0.f, e1 = r0 + 8 < sq ? db[r0 + 8] : 0.f;
  float dqa[HDP / 2];
  hopper::zero(dqa);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) % STAGES;
    if (kt + STAGES - 1 < kt_hi) {  // into the stage freed last pass
      const int nx = (st + STAGES - 1) % STAGES;
      load_tile<HD, BT>(ks + nx * T::SMALL, kb, kv_stride,
                        (kt + STAGES - 1) * BT, skv, tid);
      load_tile<HD, BT>(vs + nx * T::SMALL, vb, kv_stride,
                        (kt + STAGES - 1) * BT, skv, tid);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<STAGES - 1>();  // tile kt (and Q, dO) has landed
    hopper::fence_proxy_async();
    __syncthreads();

    const int k0 = kt * BT;
    if (wq0 < sq && k0 < wk_hi && k0 + BT > wk_lo) {
      const uint32_t kt_s = ks + st * T::SMALL;
      // S = Q K^T, then dP = dO V^T: two commit groups
      float s[32], dp[32];
      product_kmajor<HD>(s, qs, BB, wg, kt_s);
      product_kmajor<HD>(dp, dos, BB, wg, vs + st * T::SMALL);
      hopper::wgmma_wait<1>();
      hopper::fence_regs(s);

      // P; s[4j + e] is query r0 + 8*(e >> 1), key k0 + 8j + c0 + (e & 1)
      const bool edge = k0 + BT > skv || (causal && k0 + BT - 1 > wq0) ||
                        (window > 0 && k0 <= wq_last - window);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hi = (i >> 1) & 1;
        float p = expf(s[i] * scale - (hi ? l1 : l0));
        if (edge && !visible(r0 + 8 * hi, k0 + 8 * (i >> 2) + c0 + (i & 1),
                             sq, skv, causal, window))
          p = 0.f;
        s[i] = p;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = s[i] * (dp[i] - (((i >> 1) & 1) ? e1 : e0));

      // dQ += dS K: dS in bf16 as the register A operand, K read MN-major
      uint32_t da[4][4];
      hopper::to_a_frags(dp, da);
      hopper::fence_regs(dqa);
      hopper::wgmma_fence();
      product_mnmajor<HDP>(dqa, da, kt_s);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dqa);
      hopper::fence_regs(da);
    }
    __syncthreads();    // stage st is consumed before it is loaded again
  }
  hopper::cp_async_wait<0>();     // no copy outlives the block (no tiles)

  if (wq0 >= sq) return;
  store_rows<HD, HDP>(dq + q_off, q_stride, r0, c0, sq, dqa, scale);
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* delta, void* dq, void* dk, void* dv, int b, int sq,
                   int skv, int h, int kh, int causal, int window,
                   cudaStream_t stream) {
  constexpr int smem = Tile<HD>::SMEM;
  static bool opted_in = false;   // set once, before any graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        dkdv_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dq_wgmma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  using bf = __nv_bfloat16;
  const bf* qt = static_cast<const bf*>(q);
  const bf* kt = static_cast<const bf*>(k);
  const bf* vt = static_cast<const bf*>(v);
  const bf* dot = static_cast<const bf*>(dout);
  const int64_t rows = (int64_t)b * sq * h;
  delta_kernel<bf><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const bf*>(o), dot, delta, rows, sq, h, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)HD);
  const unsigned kv_blocks = (unsigned)((skv + BB - 1) / BB) * kh * b;
  dkdv_wgmma_kernel<HD><<<kv_blocks, THREADS, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf*>(dk), static_cast<bf*>(dv),
      b, sq, skv, h, kh, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned q_blocks = (unsigned)((sq + BB - 1) / BB) * h * b;
  dq_wgmma_kernel<HD><<<q_blocks, THREADS, smem, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf*>(dq), b, sq, skv, h, kh,
      causal, window, scale);
  return cudaGetLastError();
}

cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const float* lse,
                      float* delta, void* dq, void* dk, void* dv, int b,
                      int sq, int skv, int h, int kh, int causal, int window,
                      cudaStream_t s) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kh, causal, window, s);
    case 32: return launch<32>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kh, causal, window, s);
    case 64: return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kh, causal, window, s);
    case 80: return launch<80>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kh, causal, window, s);
    case 128: return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, sq, skv, h, kh, causal, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 float32 (fma-tiles), 1 bfloat16 (wgmma-bf16): q, k, v, o, dout,
// dq, dk, dv; lse and delta f32 [B, H, Sq] (delta is scratch the caller
// allocates).  window <= 0 means none.  Three launches on the caller's
// stream, not synced; returns the first CUDA error (0 on success).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int dtype, int64_t b, int64_t sq, int64_t skv, int64_t h,
    int64_t kh, int64_t hd, int causal, int64_t window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>((int)hd, q, k, v, o, dout, lse, delta, dq,
                                 dk, dv, (int)b, (int)sq, (int)skv, (int)h,
                                 (int)kh, causal, (int)window, s);
  if (dtype == 1)
    return (int)tc::launch_hd((int)hd, q, k, v, o, dout, lse, delta, dq, dk,
                              dv, (int)b, (int)sq, (int)skv, (int)h, (int)kh,
                              causal, (int)window, s);
  return (int)cudaErrorInvalidValue;
}
