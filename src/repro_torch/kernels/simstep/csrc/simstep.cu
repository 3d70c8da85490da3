// simstep: the VM-level share pass of one simulation event, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/simstep/simstep.py
// (simstep_pallas, body _simstep_kernel).  For every VM row of a dense
// [V, K] tile of cloudlet slots it computes
//   runnable &= remaining > 0
//   rank      = (inclusive count of runnable slots along K) - 1
//   space     = rank < int(pes) ? cap / pes : 0          (pes = max(req_pes, 1))
//   time      = cap / max(n_run, pes)
//   rate      = runnable ? (policy == SPACE_SHARED ? space : time) : 0
//   dt_min    = min over K of (rate > 0 ? remaining / max(rate, 1e-30) : 1e30)
// with the same IEEE float operations as the plain version
// (kernels/simstep/ref.py), so the two agree bit for bit.  Build without
// --use_fast_math: the divisions must round to nearest.
//
// Design: one warp per VM row, eight rows per block.  Pass 1 walks K in
// chunks of 32 and counts the runnable slots with __ballot_sync/__popc
// (exact integers).  Pass 2 walks again carrying the count of earlier
// chunks, so rank = base + popc(ballot & lanemask_le) - 1, writes each
// rate and keeps a per-lane running min, reduced by __shfl_xor_sync.
//
// Bound: memory.  Per slot it reads 4 B of remaining and 1 B of runnable
// and writes 4 B of rate (9 B); per row it reads 8 B (capacity, pes) and
// writes 4 B (dt_min).  A handful of float operations per slot is far
// below the card's rate, so the least time is those bytes over the HBM
// rate.  This first version is simple and exact; wider loads, several
// rows per warp when K is small, and CUDA graphs around the whole step
// are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSpaceShared = 0;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
simstep_kernel(const float* __restrict__ remaining,
               const uint8_t* __restrict__ runnable,
               const float* __restrict__ vm_capacity,
               const float* __restrict__ req_pes,
               const int32_t* __restrict__ task_policy,
               float* __restrict__ rates,
               float* __restrict__ dt_min,
               int64_t n_rows, int64_t k)
{
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
    if (row >= n_rows) return;              // uniform across the warp

    const float* rem = remaining + row * k;
    const uint8_t* run = runnable + row * k;
    float* out = rates + row * k;

    const float cap = vm_capacity[row];
    const float pes = fmaxf(req_pes[row], 1.0f);
    const int pes_i = static_cast<int>(pes);
    const bool space_policy = task_policy[0] == kSpaceShared;

    // pass 1: runnable slots in the row
    int n_run = 0;
    for (int64_t k0 = 0; k0 < k; k0 += 32) {
        const int64_t j = k0 + lane;
        bool r = false;
        if (j < k) r = run[j] != 0 && rem[j] > 0.0f;
        n_run += __popc(__ballot_sync(kFull, r));
    }

    const float per_pe = cap / pes;
    const float time_rate = cap / fmaxf(static_cast<float>(n_run), pes);
    const unsigned le_mask = lane == 31 ? kFull : ((1u << (lane + 1)) - 1u);

    // pass 2: FCFS rank, rates, running min of the completion delta
    int base = 0;
    float best = 1e30f;
    for (int64_t k0 = 0; k0 < k; k0 += 32) {
        const int64_t j = k0 + lane;
        float rm = 0.0f;
        bool r = false;
        if (j < k) {
            rm = rem[j];
            r = run[j] != 0 && rm > 0.0f;
        }
        const unsigned ballot = __ballot_sync(kFull, r);
        const int rank = base + __popc(ballot & le_mask) - 1;
        const float space = rank < pes_i ? per_pe : 0.0f;
        float rate = space_policy ? space : time_rate;
        rate = r ? rate : 0.0f;
        if (j < k) out[j] = rate;
        const float dt = rate > 0.0f ? rm / fmaxf(rate, 1e-30f) : 1e30f;
        best = fminf(best, dt);
        base += __popc(ballot);
    }
    for (int off = 16; off > 0; off >>= 1)
        best = fminf(best, __shfl_xor_sync(kFull, best, off));
    if (lane == 0) dt_min[row] = best;
}

}  // namespace

// C entry point, bound with ctypes.  Pointers are device pointers on the
// current device; the launch goes on `stream`.  Returns the cudaError_t of
// the launch (0 when it was accepted).
extern "C" int simstep_launch(const float* remaining, const uint8_t* runnable,
                              const float* vm_capacity, const float* req_pes,
                              const int32_t* task_policy, float* rates,
                              float* dt_min, int64_t n_rows, int64_t k,
                              void* stream)
{
    if (n_rows <= 0 || k <= 0) return 0;
    const int64_t blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
    simstep_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        remaining, runnable, vm_capacity, req_pes, task_policy, rates,
        dt_min, n_rows, k);
    return static_cast<int>(cudaGetLastError());
}
