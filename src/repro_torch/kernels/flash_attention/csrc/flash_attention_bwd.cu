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
// 0.02 ms at 3.35 TB/s: bound by operations.
//
// The design is the simple one that is deterministic (no float atomics):
// - delta_kernel: delta = rowsum(dO * O) in f32, one warp a row;
// - dkdv_kernel: one block of 256 threads per (64-key tile, KV head,
//   batch).  It keeps its K and V tile in shared memory and loops over the
//   G query heads of its group, then over the 64-row query tiles that see
//   any of its keys; for each it recomputes S = Q K^T (scaled),
//   P = exp(S - lse) (0 where masked), dP = dO V^T and dS = P (dP - delta),
//   and adds P^T dO into dv and dS^T Q into dk, both in registers.  The
//   sums over the group's heads and the query tiles run in one fixed
//   order;
// - dq_kernel: one block per (64-row query tile, head, batch) loops over the
//   key tiles its rows see, recomputes P and dS the same way and adds dS K
//   into dq in registers.
// P is recomputed twice and nothing is summed across blocks, so two runs
// give the same bits.  Every product is an f32 FMA on tiles staged in
// shared memory (bf16 widens exactly), as in the forward's f32 design:
// bound by the FMA pipes (67 TFLOP/s), far from the tensor-core bound.
// Tensor cores for the bf16 case (wgmma) are the next lever.  expf, not
// __expf; no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v, o, dout, dq, dk, dv); lse and
// delta f32 [B, H, Sq] (delta is scratch the caller allocates).  window <= 0
// means none.  Three launches on the caller's stream, not synced; returns
// the first CUDA error (0 on success).
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
    return (int)launch_hd<__nv_bfloat16>((int)hd, q, k, v, o, dout, lse,
                                         delta, dq, dk, dv, (int)b, (int)sq,
                                         (int)skv, (int)h, (int)kh, causal,
                                         (int)window, s);
  return (int)cudaErrorInvalidValue;
}
