// Causal GQA flash attention (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash.py::flash_attention (body
// _flash_kernel): q [B,Sq,H,hd], k/v [B,Skv,KH,hd] -> o [B,Sq,H,hd], query
// head h reading KV head h / (H/KH), an optional sliding window, an online
// softmax in f32 with masked scores set to -1e30, `q*scale` before the
// product, and `acc / max(l, 1e-30)` at the end.  Inputs f32 or bf16; the
// output has q's dtype.
//
// Bound on the card: at the main path's shape (qwen3-0.6b prefill,
// [4, 2048, 16/8, 128] bf16) the causal half of the two products is
// 4*B*H*S^2*hd/2 = 68.7 GFLOP, 0.07 ms at the 989 TFLOP/s bf16 tensor-core
// peak, against 50 MB of q/k/v/o, 0.015 ms at 3.35 TB/s: bound by
// operations.
//
// The simple design and what it does about that bound:
// - one block of 256 threads per (64-row query tile, head, batch), reading
//   the [B,S,H,hd] layout through its own offsets (no transposes);
// - the TPU grid's sequential KV axis is a loop inside the block over
//   64-key tiles, skipping tiles that lie wholly above the diagonal or
//   before the window, so the work is the causal half, not the square;
// - Q (pre-scaled), K and V tiles are staged in shared memory as f32 (bf16
//   widens exactly, as the plain version's `.float()` does); both products
//   are f32 FMAs, each thread holding a 4x4 block of scores and a 4 x hd/16
//   block of the accumulator in registers, reading Q and K as float4;
// - no tensor cores yet: the kernel is bound by f32 FMA throughput (67
//   TFLOP/s), so it stays far from the tensor-core bound.  wgmma, TMA and
//   warp specialisation are later work.
// Query rows past Sq are computed on zeros and never written.  Every real
// row has a valid key (the wrapper requires Sq <= Skv), so a row's running
// max is finite before its first store; masked scores are -1e30, never
// -inf, so no `-inf - -inf` arises.  expf, not __expf; no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 256;    // a 16 x 16 grid of (row group, column group)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q [BQ][HD], K [BK][HD+4], V [BK][HD], P [BQ][BK], all f32
  return sizeof(float) * (BQ * HD + BK * (HD + 4) + BK * HD + BQ * BK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
             int h, int kh, int causal, int window, float scale) {
  static_assert(HD % 16 == 0, "head dim must be a multiple of 16");
  constexpr int KLD = HD + 4;     // padded K row: float4 reads of 16 rows
  constexpr int CPT = HD / 16;    // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;               // [BQ][HD]
  float* ks = qs + BQ * HD;       // [BK][KLD]
  float* vs = ks + BK * KLD;      // [BK][HD]
  float* ps = vs + BK * HD;       // [BQ][BK]

  const int tid = threadIdx.x;
  const int tr = tid >> 4;        // rows tr + 16*i
  const int tc = tid & 15;        // keys tc + 16*j, output columns tc + 16*c
  const int q0 = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / kh);

  const int64_t q_stride = (int64_t)h * HD;       // between query rows
  const int64_t kv_stride = (int64_t)kh * HD;     // between key rows
  const T* qb = q + ((int64_t)b * sq * h + head) * HD;
  const T* kb = k + ((int64_t)b * skv * kh + kvh) * HD;
  const T* vb = v + ((int64_t)b * skv * kh + kvh) * HD;
  T* ob = o + ((int64_t)b * sq * h + head) * HD;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + r < sq) x = to_f32(qb[(int64_t)(q0 + r) * q_stride + d]) * scale;
    qs[i] = x;
  }

  // KV tiles that hold a valid key for some row of this query tile
  const int q_last = min(q0 + BQ, sq) - 1;
  const int k_hi = causal ? min(skv, q_last + 1) : skv;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_lo = k_lo / BK;
  const int kt_hi = (k_hi + BK - 1) / BK;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();    // the previous tile's K, V and P are consumed
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < skv) {
        kx = to_f32(kb[(int64_t)(k0 + r) * kv_stride + d]);
        vx = to_f32(vb[(int64_t)(k0 + r) * kv_stride + d]);
      }
      ks[r * KLD + d] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&qs[(tr + 16 * i) * HD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&ks[(tc + 16 * j) * KLD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        bool ok = kpos < skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        if (!ok) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row group are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(tr + 16 * i) * BK + tc + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= corr;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(tr + 16 * i) * BK + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = vs[j * HD + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + tr + 16 * i;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      store(&ob[(int64_t)qpos * q_stride + tc + 16 * c], acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int skv, int h, int kh, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // above 48 KB only with the attribute; set once, before any graph capture
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const float scale = 1.0f / sqrtf((float)HD);
  dim3 grid((sq + BQ - 1) / BQ, h, b);
  flash_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, h, kh, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, int b, int sq, int skv, int h, int kh,
                      int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, b, sq, skv, h, kh, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, sq, skv, h, kh, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, sq, skv, h, kh, causal, window, stream);
    case 80: return launch<T, 80>(q, k, v, o, b, sq, skv, h, kh, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, skv, h, kh, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  window <= 0 means none.  Returns the CUDA
// error of the launch (0 on success); the caller's stream is not synced.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int64_t b, int64_t sq, int64_t skv,
                                      int64_t h, int64_t kh, int64_t hd,
                                      int causal, int64_t window,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>((int)hd, q, k, v, o, (int)b, (int)sq,
                                 (int)skv, (int)h, (int)kh, causal,
                                 (int)window, s);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>((int)hd, q, k, v, o, (int)b,
                                         (int)sq, (int)skv, (int)h, (int)kh,
                                         causal, (int)window, s);
  return (int)cudaErrorInvalidValue;
}
