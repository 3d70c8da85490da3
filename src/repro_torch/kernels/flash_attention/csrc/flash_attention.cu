// Causal GQA flash attention (forward) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash.py::flash_attention (body
// _flash_kernel): q [B,Sq,H,hd], k/v [B,Skv,KH,hd] -> o [B,Sq,H,hd], query
// head h reading KV head h / (H/KH), an optional sliding window, an online
// softmax in f32 with masked scores set to -1e30, and `acc / max(l, 1e-30)`
// at the end.  Inputs f32 or bf16; the output has q's dtype.  When the
// caller passes an `lse` buffer (training: autograd keeps it for the
// backward in flash_attention_bwd.cu), both designs also write each row's
// log-sum-exp of its scaled scores, m + log(l), f32 [B, H, Sq]; the output
// is computed as without it.
//
// Bound on the card: at the main path's shape (qwen3-0.6b prefill,
// [4, 2048, 16/8, 128] bf16) the causal half of the two products is
// 4*B*H*S^2*hd/2 = 68.7 GFLOP, 0.07 ms at the 989 TFLOP/s bf16 tensor-core
// peak, against 50 MB of q/k/v/o, 0.015 ms at 3.35 TB/s: bound by
// operations.  Two designs, chosen by dtype:
//
// flash_wgmma_kernel, bf16 (the main path): tensor cores.
// - one block of two warpgroups per (128-row query tile, head, batch); each
//   warpgroup owns 64 query rows, wgmma's M.  The 1-D grid runs the query
//   tiles heaviest first (the last tile of a causal prefill has the most
//   keys), so the diagonal-heavy tiles do not form a tail;
// - Q is staged once in shared memory as bf16; K and V run through a
//   3-stage ring of 64-key bf16 tiles, loaded with cp.async (zero fill past
//   Skv and past hd): the loads of tiles j+1 and j+2 are in flight while
//   tile j is computed.  Tiles are 128-byte swizzled (64 columns of bf16 a
//   swizzle atom), hd padded with zero columns to 64 or 128;
// - S = Q.K^T is wgmma m64n64k16 with both operands in shared memory (Q and
//   K are both K-major in the [B,S,H,hd] layout, so nothing is transposed);
//   the 1/sqrt(hd) scale multiplies the f32 scores, so Q stays bf16-exact;
// - the online softmax runs on the f32 accumulator in registers (row max
//   and sum over the four threads that share a row, masked scores -1e30,
//   expf); P is rounded to bf16 in registers and is the register A operand
//   of wgmma m64n{64,128}k16 against V read MN-major from shared memory (the
//   transpose bit).  O accumulates in f32 registers; rounding P to bf16
//   before the PV product is FlashAttention's rounding, within the 2e-2 bf16
//   tolerance of tests/test_kernels.py;
// - causal and window tiles that hold no valid key for a block (or for one
//   warpgroup's rows) are skipped;
// - the kernel makes no call (the epilogue's division is inline, see
//   hopper::div_normal): ptxas serializes every wgmma of a kernel that does.
// It is bound by issue of the softmax's instructions (the accurate expf is
// 8 of them), with the two warpgroups in step: overlapping one warpgroup's
// softmax with the other's wgmma is the next lever.
//
// flash_kernel, instantiated for f32: f32 FMAs, exact to 2e-5 against the
// plain version (TF32 tensor cores would not be).
// - one block of 256 threads per (64-row query tile, head, batch), reading
//   the [B,S,H,hd] layout through its own offsets (no transposes);
// - the TPU grid's sequential KV axis is a loop inside the block over
//   64-key tiles, skipping tiles that lie wholly above the diagonal or before
//   the window, so the work is the causal half, not the square;
// - Q (pre-scaled, `q*scale` as in the Pallas kernel), K and V tiles are
//   staged in shared memory as f32 (bf16 widens exactly, as the plain
//   version's `.float()` does); both products are f32 FMAs, each thread
//   holding a 4x4 block of scores and a 4 x hd/16 block of the accumulator
//   in registers, reading Q and K as float4;
// - bound by f32 FMA throughput (67 TFLOP/s), far from the tensor-core
//   bound.
// Query rows past Sq are computed on zeros and never written.  Every real
// row has a valid key (the wrapper requires Sq <= Skv), so a row's running
// max is finite before its first store; masked scores are -1e30, never
// -inf, so no `-inf - -inf` arises, and the `exp(m_prev - m_new)` correction
// wipes what a fully masked tile added.  expf, not __expf; no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int THREADS = 256;    // a 16 x 16 grid of (row group, column group)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <int HD>
constexpr size_t smem_bytes() {
  // Q [BQ][HD], K [BK][HD+4], V [BK][HD], P [BQ][BK], all f32
  return sizeof(float) * (BQ * HD + BK * (HD + 4) + BK * HD + BQ * BK);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int sq, int skv, int h, int kh,
             int causal, int window, float scale) {
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
    // l[i] is the row's whole sum in each of its 16 threads
    if (lse != nullptr && tc == 0)
      lse[((int64_t)b * h + head) * sq + qpos] = m[i] + logf(denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int skv, int h, int kh,
                   int causal, int window, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, h, kh,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, float* lse, int b, int sq, int skv, int h,
                      int kh, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, lse, b, sq, skv, h, kh, causal, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, b, sq, skv, h, kh, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, b, sq, skv, h, kh, causal, window, stream);
    case 80: return launch<T, 80>(q, k, v, o, lse, b, sq, skv, h, kh, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, sq, skv, h, kh, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// bf16 on tensor cores

namespace tc {

constexpr int BQ = 128;         // query rows per block: two warpgroups of 64
constexpr int BK = 64;          // keys per K/V tile
constexpr int STAGES = 3;       // K/V ring: tiles kt+1 and kt+2 in flight
constexpr int THREADS = 256;

template <int HD>
struct Tile {
  static constexpr int HDP = HD <= 64 ? 64 : 128;   // hd padded to atoms
  static constexpr int Q_BYTES = BQ * HDP * 2;
  static constexpr int KV_BYTES = BK * HDP * 2;     // one K or V tile
  // Q, then the K ring, then the V ring; + slack to align to 1024 bytes
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

template <int HD, int R>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t row_stride, int row0,
                                          int rows, int tid) {
  hopper::load_tile<HD, Tile<HD>::HDP, R, THREADS>(dst, src, row_stride,
                                                   row0, rows, tid);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int bsz, int sq, int skv, int h, int kh, int causal,
                   int window, float scale) {
  using T = Tile<HD>;
  constexpr int HDP = T::HDP;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t qs = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t ks = qs + T::Q_BYTES;              // K ring
  const uint32_t vs = ks + STAGES * T::KV_BYTES;    // V ring

  const int tid = threadIdx.x;
  const int wg = tid / 128;                         // warpgroup: rows 64*wg
  const int warp = (tid % 128) / 32;                // rows 16*warp of those
  const int lane = tid % 32;
  // heaviest query tile first: the tile index runs down as blockIdx.x runs up
  const int n_qt = (sq + BQ - 1) / BQ;
  const int qt = n_qt - 1 - (int)(blockIdx.x / (bsz * h));
  const int head = blockIdx.x % h;
  const int b = (blockIdx.x / h) % bsz;
  const int kvh = head / (h / kh);
  const int q0 = qt * BQ;

  const int64_t q_stride = (int64_t)h * HD;         // between query rows
  const int64_t kv_stride = (int64_t)kh * HD;       // between key rows
  const __nv_bfloat16* qb = q + ((int64_t)b * sq * h + head) * HD;
  const __nv_bfloat16* kb = k + ((int64_t)b * skv * kh + kvh) * HD;
  const __nv_bfloat16* vb = v + ((int64_t)b * skv * kh + kvh) * HD;
  __nv_bfloat16* ob = o + ((int64_t)b * sq * h + head) * HD;

  // KV tiles that hold a valid key for some row of the block ...
  const int q_last = min(q0 + BQ, sq) - 1;
  const int kt_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / BK;
  const int kt_hi = ((causal ? min(skv, q_last + 1) : skv) + BK - 1) / BK;
  // ... and for some row of this warpgroup (none if its rows are past Sq)
  const int wq0 = q0 + 64 * wg;
  const int wq_last = min(wq0 + 64, sq) - 1;
  const int wk_lo = window > 0 ? max(0, wq0 - window + 1) : 0;
  const int wk_hi = causal ? min(skv, wq_last + 1) : skv;

  // Q with the first tile, then one commit group a tile, STAGES-1 ahead
  load_tile<HD, BQ>(qs, qb, q_stride, q0, sq, tid);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (kt_lo + i < kt_hi) {
      load_tile<HD, BK>(ks + i * T::KV_BYTES, kb, kv_stride, (kt_lo + i) * BK,
                        skv, tid);
      load_tile<HD, BK>(vs + i * T::KV_BYTES, vb, kv_stride, (kt_lo + i) * BK,
                        skv, tid);
    }
    hopper::cp_async_commit();
  }

  // this thread's accumulator rows and first column (wgmma's D layout)
  const int r0 = wq0 + 16 * warp + lane / 4;        // and r0 + 8
  const int c0 = 2 * (lane % 4);
  float acc[HDP / 2];
  hopper::zero(acc);
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // l: this thread's

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) % STAGES;
    if (kt + STAGES - 1 < kt_hi) {  // into the stage freed last pass
      const int nx = (st + STAGES - 1) % STAGES;
      load_tile<HD, BK>(ks + nx * T::KV_BYTES, kb, kv_stride,
                        (kt + STAGES - 1) * BK, skv, tid);
      load_tile<HD, BK>(vs + nx * T::KV_BYTES, vb, kv_stride,
                        (kt + STAGES - 1) * BK, skv, tid);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<STAGES - 1>();  // tile kt (and Q) has landed
    hopper::fence_proxy_async();
    __syncthreads();

    const int k0 = kt * BK;
    if (wq0 < sq && k0 < wk_hi && k0 + BK > wk_lo) {
      // S = Q K^T: K-major A (this warpgroup's Q rows) and B (the K rows),
      // 16 hd columns (32 bytes) a step
      float s[BK / 2];
      hopper::zero(s);
      hopper::fence_regs(s);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HDP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        hopper::wgmma_ss_m64n64k16(
            s,
            hopper::desc128(qs + (kk / 4) * BQ * 128 + wg * 64 * 128 + off,
                            16, 1024),
            hopper::desc128(ks + st * T::KV_BYTES + (kk / 4) * BK * 128 + off,
                            16, 1024));
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // scale, mask, online softmax; s[4j + e] is row r0 + 8*(e >> 1),
      // key k0 + 8j + c0 + (e & 1)
      const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > wq0) ||
                        (window > 0 && k0 <= wq_last - window);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = s[i] * scale;
        if (edge) {
          const int qpos = r0 + 8 * ((i >> 1) & 1);
          const int kpos = k0 + 8 * (i >> 2) + c0 + (i & 1);
          bool ok = kpos < skv;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) x = NEG_INF;
        }
        s[i] = x;
        if ((i >> 1) & 1) mx1 = fmaxf(mx1, x);
        else mx0 = fmaxf(mx0, x);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        if ((i >> 1) & 1) {
          s[i] = expf(s[i] - mn1);
          rs1 += s[i];
        } else {
          s[i] = expf(s[i] - mn0);
          rs0 += s[i];
        }
      }
      const float cr0 = expf(m0 - mn0), cr1 = expf(m1 - mn1);
      l0 = l0 * cr0 + rs0;
      l1 = l1 * cr1 + rs1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] *= ((i >> 1) & 1) ? cr1 : cr0;

      // P in bf16 as wgmma's register A operand, keys 16kk..16kk+15
      uint32_t p[BK / 16][4];
      hopper::to_a_frags(s, p);
      // O += P V: V [keys][hd] is MN-major; 1024 bytes between groups of 8
      // keys, BK*128 bytes between 64-column atoms
      hopper::fence_regs(acc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = hopper::desc128(
            vs + st * T::KV_BYTES + kk * 16 * 128, BK * 128, 1024);
        if constexpr (HDP == 64) hopper::wgmma_rs_m64n64k16(acc, p[kk], db);
        else hopper::wgmma_rs_m64n128k16(acc, p[kk], db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(p);
    }
    __syncthreads();    // stage st is consumed before it is loaded again
  }

  if (wq0 >= sq) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  // a real row's sum holds exp(0) = 1 for its max, so l >= 1 and the
  // division has no slow path to take
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  // m and l are the row's in each of the four threads of a quad
  if (lse != nullptr && lane % 4 == 0) {
    float* lb = lse + ((int64_t)b * h + head) * sq;
    if (r0 < sq) lb[r0] = m0 + logf(d0);
    if (r0 + 8 < sq) lb[r0 + 8] = m1 + logf(d1);
  }
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + c0;
    if (col >= HD) continue;
    if (r0 < sq)
      *reinterpret_cast<__nv_bfloat162*>(&ob[(int64_t)r0 * q_stride + col]) =
          __floats2bfloat162_rn(hopper::div_normal(acc[4 * j], d0),
                                hopper::div_normal(acc[4 * j + 1], d0));
    if (r0 + 8 < sq)
      *reinterpret_cast<__nv_bfloat162*>(
          &ob[(int64_t)(r0 + 8) * q_stride + col]) =
          __floats2bfloat162_rn(hopper::div_normal(acc[4 * j + 2], d1),
                                hopper::div_normal(acc[4 * j + 3], d1));
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int sq, int skv, int h, int kh,
                   int causal, int window, cudaStream_t stream) {
  constexpr int smem = Tile<HD>::SMEM;
  static bool opted_in = false;   // set once, before any graph capture
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const float scale = 1.0f / sqrtf((float)HD);
  const unsigned blocks = (unsigned)((sq + BQ - 1) / BQ) * h * b;
  flash_wgmma_kernel<HD><<<blocks, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, b, sq, skv, h, kh, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v,
                      void* o, float* lse, int b, int sq, int skv, int h,
                      int kh, int causal, int window, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<16>(q, k, v, o, lse, b, sq, skv, h, kh, causal, window, stream);
    case 32: return launch<32>(q, k, v, o, lse, b, sq, skv, h, kh, causal, window, stream);
    case 64: return launch<64>(q, k, v, o, lse, b, sq, skv, h, kh, causal, window, stream);
    case 80: return launch<80>(q, k, v, o, lse, b, sq, skv, h, kh, causal, window, stream);
    case 128: return launch<128>(q, k, v, o, lse, b, sq, skv, h, kh, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 float32 (the FMA kernel), 1 bfloat16 (the tensor-core kernel).
// window <= 0 means none; lse null (serving) or f32 [B, H, Sq] (training).
// Returns the CUDA error of the launch (0 on success); the caller's stream
// is not synced.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int dtype,
                                      int64_t b, int64_t sq, int64_t skv,
                                      int64_t h, int64_t kh, int64_t hd,
                                      int causal, int64_t window,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)tc::launch_hd((int)hd, q, k, v, o, lse, (int)b, (int)sq,
                              (int)skv, (int)h, (int)kh, causal, (int)window,
                              s);
  if (dtype == 0)
    return (int)launch_hd<float>((int)hd, q, k, v, o, lse, (int)b, (int)sq,
                                 (int)skv, (int)h, (int)kh, causal,
                                 (int)window, s);
  return (int)cudaErrorInvalidValue;
}
