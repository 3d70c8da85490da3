// simstep: the VM-level share pass of one simulation event, for Hopper,
// on the flat, ragged, grouped-by-VM cloudlet axis.
//
// Replaces the TPU kernel src/repro/kernels/simstep/simstep.py
// (simstep_pallas, body _simstep_kernel), which works on a dense [V, K]
// tile.  Here a VM row is the contiguous run of flat slots that the
// grouped invariant gives it (slot_row[j] is the row of slot j, -1 for a
// slot with no row).  For every row it computes
//   runnable &= remaining > 0
//   rank      = (inclusive count of runnable slots along the row) - 1
//   space     = rank < int(pes) ? cap / pes : 0     (pes = max(req_pes, 1))
//   time      = cap / max(n_run, pes)
//   rate      = runnable ? (policy == SPACE_SHARED ? space : time) : 0
// where policy is one i32 for every row, or the row's own entry of an
// i32[V] (a batch of lanes, each with its own task policy, flattened into
// one axis of rows)
//   dt        = rate > 0 ? remaining / max(rate, 1e-30) : 1e30
//   dt_min    = min over the row of dt
// with the same IEEE float operations as the plain version
// (kernels/simstep/ref.py::simstep_ragged_ref), so the two agree bit for
// bit.  A slot with no row gets rate 0; a row with no slot gets 1e30.
// Build without --use_fast_math: the divisions must round to nearest.
//
// Bound: at the simulator's sizes (10 slots a row, 500,000 slots) the
// call moves ~7 MB, 2 us of HBM time, and the data stays in L2 between
// events; what sets its time is instruction issue: an earlier design that
// gave each warp two 32-slot halves (rows starting in the first) took
// twice as long on the same slots (PERF.md).  So the design spends as few
// instructions per slot as it can: every lane busy, one pass, every slot
// read once.
//
// Design ("ragged-packed-warp"):
// - Short rows (<= 32 slots).  The index packs whole rows, and the slots
//   of no row between them, into windows of at most 32 slots
//   (RowIndex.window, built once per run).  One warp takes one window,
//   a lane a slot: coalesced 4-byte loads of remaining and slot_row and
//   1-byte loads of runnable, all independent of each other.  Row
//   boundaries are a ballot of where slot_row changes; ranks and counts
//   are __popc of the runnable ballot under the row's segment mask;
//   dt_min is a segmented shuffle min that leaves each row's minimum in
//   its first lane.  Values stay in registers from the count to the rate.
//   The warp also writes rate 0 to its slots of no row.
// - Long rows (> 32 slots; the index lists them and spans each with a
//   window the short-row kernel skips) are cut into chunks of 1024 slots.
//   A count pass writes each chunk's runnable count (and sets the row's
//   dt_min to 1e30); a rate pass reads its row's chunk counts for n_run
//   and its rank base, writes rates and folds the chunk's min into
//   dt_min with an integer atomicMin on the float bits: every candidate is
//   >= 0 (a quotient of positives, or 1e30), so integer order is float
//   order and the min is exact in any order.  Both passes launch only when
//   there are long rows.
// - Rows with no slot: the first threads of the short-row kernel write
//   their 1e30 from the index's list of empty rows.
// - A padded index (a streamed window's, rebuilt on the device with no
//   host read, so its lists have sizes fixed by the slot count) ends its
//   windows with empty spans [C, C], which write nothing, and pads the
//   empty-row and chunk lists with -1 entries, which are skipped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpaceShared = 0;
constexpr float kInf = 1e30f;
constexpr int kWarpsPerBlock = 8;
constexpr int kChunk = 1024;            // slots of a long row per block
constexpr int kChunkThreads = 256;
constexpr int kChunkWarps = kChunkThreads / 32;

// the rate of a slot and its completion delta, as the plain version
__device__ __forceinline__ float slot_rate(bool r, int rank, int n_run,
                                           float cap, float pes, bool space)
{
    const float per_pe = cap / pes;
    const float space_rate = rank < static_cast<int>(pes) ? per_pe : 0.0f;
    const float time_rate = cap / fmaxf(static_cast<float>(n_run), pes);
    return r ? (space ? space_rate : time_rate) : 0.0f;
}

__device__ __forceinline__ float slot_dt(float rate, float rm)
{
    return rate > 0.0f ? rm / fmaxf(rate, 1e-30f) : kInf;
}

__device__ __forceinline__ unsigned mask_le(int n)     // bits [0, n]
{
    return n >= 31 ? kFull : (2u << n) - 1u;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
window_kernel(const float* __restrict__ remaining,
              const uint8_t* __restrict__ runnable,
              const int32_t* __restrict__ slot_row,
              const float* __restrict__ vm_capacity,
              const float* __restrict__ req_pes,
              const int32_t* __restrict__ task_policy, int per_row,
              const int32_t* __restrict__ window, int64_t n_windows,
              const int32_t* __restrict__ empty_rows, int64_t n_empty,
              float* __restrict__ rates, float* __restrict__ dt_min)
{
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x
                        + threadIdx.x;
    if (tid < n_empty) {
        const int e = empty_rows[tid];
        if (e >= 0) dt_min[e] = kInf;           // -1 pads the list
    }

    const int lane = threadIdx.x & 31;
    const int64_t w = tid >> 5;
    if (w >= n_windows) return;                 // uniform across the warp
    const int first = window[w], last = window[w + 1];
    if (last - first > 32) return;              // a long row's span

    // a window starts at a row's first slot or at a slot of no row
    const int j = first + lane;
    const bool in = j < last;
    int row = -1;
    float rm = 0.0f;
    bool r = false;
    if (in) {
        row = slot_row[j];
        rm = remaining[j];
        r = runnable[j] != 0;
    }
    r = r && rm > 0.0f && row >= 0;
    const int up = __shfl_up_sync(kFull, row, 1);
    const unsigned starts =
        __ballot_sync(kFull, row >= 0 && (lane == 0 || row != up));
    const unsigned bounds = starts | __ballot_sync(kFull, row < 0);
    const unsigned run = __ballot_sync(kFull, r);

    float d = kInf;
    int head = 0, end = 0;
    if (row >= 0) {
        head = 31 - __clz(starts & mask_le(lane));
        const unsigned later = bounds & ~mask_le(head);
        end = later ? __ffs(later) - 1 : 32;
        const unsigned seg = (end == 32 ? kFull : (1u << end) - 1u)
                             & ~((1u << head) - 1u);
        const int rank = __popc(run & seg & mask_le(lane)) - 1;
        const bool space = task_policy[per_row ? row : 0] == kSpaceShared;
        const float rate = slot_rate(r, rank, __popc(run & seg),
                                     vm_capacity[row],
                                     fmaxf(req_pes[row], 1.0f), space);
        rates[j] = rate;
        d = slot_dt(rate, rm);
    } else if (in) {
        rates[j] = 0.0f;
    }
    // segmented min: lane i folds lanes i+1 .. end-1 of its own row, so
    // each row's first lane ends with the row's min
    for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_down_sync(kFull, d, off);
        if (lane + off < end) d = fminf(d, o);
    }
    if (row >= 0 && head == lane) dt_min[row] = d;
}

// Long rows, pass 1: each chunk's runnable count.
__global__ void __launch_bounds__(kChunkThreads)
long_count_kernel(const float* __restrict__ remaining,
                  const uint8_t* __restrict__ runnable,
                  const int32_t* __restrict__ row_start,
                  const int32_t* __restrict__ row_len,
                  const int32_t* __restrict__ chunk_row,
                  const int32_t* __restrict__ chunk_first,
                  int32_t* __restrict__ chunk_count,
                  float* __restrict__ dt_min)
{
    const int c = blockIdx.x;
    const int row = chunk_row[c];
    if (row < 0) return;                        // a padded chunk
    const int k = c - chunk_first[c];
    const int64_t end = static_cast<int64_t>(row_start[row]) + row_len[row];
    const int64_t begin = static_cast<int64_t>(row_start[row])
                          + static_cast<int64_t>(k) * kChunk;
    int n = 0;
    for (int64_t j0 = begin; j0 < end && j0 < begin + kChunk;
         j0 += kChunkThreads) {
        const int64_t j = j0 + threadIdx.x;
        n += __syncthreads_count(j < end && runnable[j] != 0
                                 && remaining[j] > 0.0f);
    }
    if (threadIdx.x == 0) {
        chunk_count[c] = n;
        if (k == 0) dt_min[row] = kInf;
    }
}

// Long rows, pass 2: ranks from the chunk counts, rates, dt_min.
__global__ void __launch_bounds__(kChunkThreads)
long_rate_kernel(const float* __restrict__ remaining,
                 const uint8_t* __restrict__ runnable,
                 const float* __restrict__ vm_capacity,
                 const float* __restrict__ req_pes,
                 const int32_t* __restrict__ task_policy, int per_row,
                 const int32_t* __restrict__ row_start,
                 const int32_t* __restrict__ row_len,
                 const int32_t* __restrict__ chunk_row,
                 const int32_t* __restrict__ chunk_first,
                 const int32_t* __restrict__ chunk_count,
                 float* __restrict__ rates, float* __restrict__ dt_min)
{
    __shared__ int warp_a[kChunkWarps], warp_b[kChunkWarps];
    __shared__ float warp_min[kChunkWarps];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int c = blockIdx.x;
    const int row = chunk_row[c];
    if (row < 0) return;                        // a padded chunk
    const int first = chunk_first[c];
    const int len = row_len[row];
    const int64_t end = static_cast<int64_t>(row_start[row]) + len;
    const int64_t begin = static_cast<int64_t>(row_start[row])
                          + static_cast<int64_t>(c - first) * kChunk;

    // the row's count and this chunk's base, from the count pass
    int total = 0, base = 0;
    const int n_chunks = (len + kChunk - 1) / kChunk;
    for (int i = threadIdx.x; i < n_chunks; i += kChunkThreads) {
        const int x = chunk_count[first + i];
        total += x;
        if (first + i < c) base += x;
    }
    for (int off = 16; off > 0; off >>= 1) {
        total += __shfl_xor_sync(kFull, total, off);
        base += __shfl_xor_sync(kFull, base, off);
    }
    if (lane == 0) {
        warp_a[warp] = total;
        warp_b[warp] = base;
    }
    __syncthreads();
    total = base = 0;
    for (int w = 0; w < kChunkWarps; ++w) {
        total += warp_a[w];
        base += warp_b[w];
    }
    __syncthreads();                            // warp_a is reused below

    const float cap = vm_capacity[row];
    const float pes = fmaxf(req_pes[row], 1.0f);
    const bool space = task_policy[per_row ? row : 0] == kSpaceShared;
    const unsigned le = lane == 31 ? kFull : (1u << (lane + 1)) - 1u;
    float best = kInf;
    for (int64_t j0 = begin; j0 < end && j0 < begin + kChunk;
         j0 += kChunkThreads) {
        const int64_t j = j0 + threadIdx.x;
        float rm = 0.0f;
        bool r = false;
        if (j < end) {
            rm = remaining[j];
            r = runnable[j] != 0 && rm > 0.0f;
        }
        const unsigned ballot = __ballot_sync(kFull, r);
        if (lane == 0) warp_a[warp] = __popc(ballot);
        __syncthreads();
        int ahead = base, round = 0;
        for (int w = 0; w < kChunkWarps; ++w) {
            ahead += w < warp ? warp_a[w] : 0;
            round += warp_a[w];
        }
        const int rank = ahead + __popc(ballot & le) - 1;
        const float rate = slot_rate(r, rank, total, cap, pes, space);
        if (j < end) {
            rates[j] = rate;
            best = fminf(best, slot_dt(rate, rm));
        }
        base += round;
        __syncthreads();
    }
    for (int off = 16; off > 0; off >>= 1)
        best = fminf(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) warp_min[warp] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kChunkWarps; ++w) best = fminf(best, warp_min[w]);
        atomicMin(reinterpret_cast<int*>(dt_min + row), __float_as_int(best));
    }
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers on the
// current device; the launches go on `stream` in order (the short-row
// kernel, then the two long-row passes when n_chunks > 0).  task_policy
// holds one i32 (per_row == 0) or one a row (per_row != 0).  chunk_count
// is scratch of n_chunks ints.  Returns the first non-zero cudaError_t of
// the launches (0 when every one was accepted).
extern "C" int simstep_ragged_launch(
    const float* remaining, const uint8_t* runnable, const int32_t* slot_row,
    const float* vm_capacity, const float* req_pes,
    const int32_t* task_policy, int per_row, const int32_t* window,
    int64_t n_windows,
    const int32_t* empty_rows, int64_t n_empty, const int32_t* row_start,
    const int32_t* row_len, const int32_t* chunk_row,
    const int32_t* chunk_first, int64_t n_chunks, int32_t* chunk_count,
    float* rates, float* dt_min, void* stream)
{
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int64_t per_block = kWarpsPerBlock * 32;
    int64_t blocks = (n_windows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const int64_t empty_blocks = (n_empty + per_block - 1) / per_block;
    if (empty_blocks > blocks) blocks = empty_blocks;
    if (blocks > 0) {
        window_kernel<<<static_cast<unsigned>(blocks), per_block, 0, s>>>(
            remaining, runnable, slot_row, vm_capacity, req_pes, task_policy,
            per_row, window, n_windows, empty_rows, n_empty, rates, dt_min);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (n_chunks <= 0) return 0;
    long_count_kernel<<<static_cast<unsigned>(n_chunks), kChunkThreads, 0,
                        s>>>(remaining, runnable, row_start, row_len,
                             chunk_row, chunk_first, chunk_count, dt_min);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    long_rate_kernel<<<static_cast<unsigned>(n_chunks), kChunkThreads, 0,
                       s>>>(remaining, runnable, vm_capacity, req_pes,
                            task_policy, per_row, row_start, row_len,
                            chunk_row, chunk_first, chunk_count, rates,
                            dt_min);
    err = cudaGetLastError();
    return static_cast<int>(err);
}
