// deposit_visit: one transport step's per-cell statistics, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hyperion_tpu/transport/pallas_ops.py::deposit_visit
// (body _deposit_visit_kernel). For every lane i of a batch of B lanes:
//
//   energy_sum[d, cell_dep[i]] += dep[i, d]                  for every dust d
//   fresh[i] = last_uid[enter[i]] != uid[i]                  table read BEFORE this call
//   n_photons[enter[i]] += fresh[i]                          where enter[i] < n_cells
//   last_uid[c] = max{uid[i] : enter[i] == c}                where some lane entered c
//
// enter[i] == n_cells is the drop slot: the lane entered no cell. The last-uid
// update OVERWRITES an entered cell's uid with the largest uid that entered it
// in this call; it does not keep a running maximum over time (uids 5, 3, 5 in
// three calls leave 5 and count 3), so it cannot be an atomicMax into last_uid.
//
// What bounds it on this card: bytes. The lanes bring (20 + 4 n_dust) B bytes
// (int64 cells, int32 uids, float32 deposits); the tables are read and written
// only where a lane touches them. At B = 125,000 that is ~3 MB, about 1 us at
// 3.35 TB/s: far below one launch's fixed cost. The PR 1 design paid four
// other costs; what this design does about each:
//
// 1. Same-address atomics. After a refill ~30% of the lanes deposit into and
//    enter the source's cell, and each lane issued its own atomics there. Here
//    the lanes of a warp are grouped by cell with __match_any_sync, once on
//    cell_dep and once on enter, and only the group's lowest lane touches L2:
//    one float atomicAdd per dust of the group's sum (a shuffle tree over the
//    group, group_sum below), one int64 atomicAdd of the group's fresh count
//    (__popc of a ballot) and one atomicMax of the group's largest uid
//    (__reduce_max_sync). That is at most 1/32 of the old atomics on a hot
//    cell. The float sums run in another order than the plain version's.
//    Lanes on distinct cells still cost one atomic each per table (energy,
//    count, last uid): those scattered atomics, not the bytes, bound a call
//    whose lanes spread, as the tutorial's do. A merge across the block's
//    warps in a shared-memory hash table cuts a hot cell's atomics 8x more
//    (4.8 against 9.6 us at the hot cell on an H100), but on the tutorial's
//    own calls, whose busiest cell holds at most 3.7% of the lanes, setting
//    the table up costs more than it saves (13.0 against 12.3 us per call):
//    it is not done here.
// 2. Two launches per call. A call's maxima go into a scratch table that the
//    NEXT call's launch commits into last_uid, so one launch does both. Three
//    scratch tables (INT_MIN where untouched) take turns: in call k, win_cur
//    takes this call's maxima, win_prev holds call k-1's, and win_old holds
//    call k-2's, which call k-1 already committed. Threads c < n_cells copy
//    win_prev[c] into last_uid[c] where it is set, and reset win_old[c] for
//    its turn as win_cur in call k+1. A lane reads the table before this call
//    as win_prev[c] where that is set, else last_uid[c]: the launch writes
//    last_uid[c] only where win_prev[c] is set, and nothing writes win_prev,
//    so no lane reads what this launch writes, and no fence or ordering is
//    needed there. The turn k % 3 lives on the device (state[0]), so a CUDA
//    graph that holds any number of calls replays exactly, any number of
//    times. Thread 0 of each block reads it into shared memory and then
//    counts its block in (state[1]) with a release add, before it writes
//    anything global, so the add waits for nothing; the block that counts
//    in last takes an acquire fence at its end and advances the turn for
//    the next launch. Every block has read the turn before it counts in, so
//    none reads the advanced one. The grid is max(B, n_cells) threads.
//    last_uid lags one call behind until the wrapper's flush(), which is
//    this kernel with B = 0 (commit only).
// 3. Host cost per call (the wrapper): argtypes set once, table pointers
//    checked and cached once per iteration, the raw stream handle as an int,
//    no allocation and no synchronisation: the call captures in a CUDA graph.
// 4. Conversion launches at the call sites: the kernel takes the step's own
//    tensors, int64 cell indices and deposit rows in (B, n_dust) layout.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (hyperion_tpu_torch/transport/_build.py).
// One launch on the caller's stream; nothing here allocates or syncs.

#include <climits>
#include <cuda/atomic>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// The sum of x over the lanes of `peers` (this lane's __match_any_sync group),
// in the group's lowest lane; other lanes get partial sums. A tree over the
// group in at most 5 rounds: in round r each lane adds the value of its next
// remaining peer, and the peers whose relative position has bit r set drop
// out. Every lane of the warp must call it (full-warp shuffles).
__device__ __forceinline__ float group_sum(unsigned peers, float x, int lane) {
  unsigned rel = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & (0xfffffffeu << lane);
  while (__any_sync(kFull, rest != 0u)) {
    const int next = __ffs(rest);  // 1-based, 0 when none is left
    const float t = __shfl_sync(kFull, x, (next - 1) & 31);
    if (next) x += t;
    rest &= ~__ballot_sync(kFull, rel & 1u);
    rel >>= 1;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
deposit_visit_kernel(float* __restrict__ energy_sum,
                     unsigned long long* __restrict__ n_photons,
                     int* __restrict__ last_uid, int* __restrict__ win,
                     unsigned* __restrict__ state,
                     const long long* __restrict__ cell_dep,
                     const float* __restrict__ dep,
                     const long long* __restrict__ enter,
                     const int* __restrict__ uid,
                     int n_dust, int n_cells, int B) {
  __shared__ unsigned block_turn;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool lane_ok = t < B;
  cuda::atomic_ref<unsigned, cuda::thread_scope_device> turn_ref(state[0]);
  cuda::atomic_ref<unsigned, cuda::thread_scope_device> counted(state[1]);

  // the lanes' inputs do not depend on the turn: load them first
  const long long cd = (lane_ok && n_dust > 0) ? cell_dep[t] : -1;
  const long long c = lane_ok ? enter[t] : -1;
  const int u = lane_ok ? uid[t] : INT_MIN;
  if (threadIdx.x == 0) block_turn = turn_ref.load(cuda::memory_order_relaxed);
  // No thread returns early: the warp votes and shuffles take all 32 lanes,
  // and the barrier all of the block.
  __syncthreads();
  // this call's turn k: win_cur is table k % 3, win_prev (k - 1) % 3 and
  // win_old (k - 2) % 3 (see 2. above); the block counts itself in
  const unsigned turn = block_turn;
  const unsigned n_counted =
      threadIdx.x == 0 ? counted.fetch_add(1u, cuda::memory_order_release) : 0u;
  const size_t stride = static_cast<size_t>(n_cells) + 1;
  int* win_cur = win + turn * stride;
  const int* win_prev = win + ((turn + 2u) % 3u) * stride;
  int* win_old = win + ((turn + 1u) % 3u) * stride;

  // commit the previous call's maxima; clear the table committed before it
  if (t < n_cells) {
    const int w = win_prev[t];
    if (w != INT_MIN) last_uid[t] = w;
    if (win_old[t] != INT_MIN) win_old[t] = INT_MIN;
  }

  // deposits, summed per cell within the warp
  if (n_dust > 0) {
    const int dkey = (cd >= 0 && cd < n_cells) ? static_cast<int>(cd) : -1;
    const unsigned dpeers = __match_any_sync(kFull, dkey);
    const bool dlead = dkey >= 0 && lane == __ffs(dpeers) - 1;
    for (int d = 0; d < n_dust; ++d) {
      const float v = dkey >= 0 ? dep[static_cast<size_t>(t) * n_dust + d] : 0.0f;
      const float s = group_sum(dpeers, v, lane);
      // a zero sum (masked lanes carry 0) adds nothing: skip its atomic
      if (dlead && s != 0.0f)
        atomicAdd(&energy_sum[static_cast<size_t>(d) * n_cells + dkey], s);
    }
  }

  // unique visits, counted and maximised per cell within the warp (counts
  // are non-negative, so the unsigned add is the int64 add)
  const int ekey = (c >= 0 && c < n_cells) ? static_cast<int>(c) : -1;
  bool fresh = false;
  if (ekey >= 0) {
    const int w = win_prev[ekey];
    fresh = (w != INT_MIN ? w : last_uid[ekey]) != u;
  }
  const unsigned epeers = __match_any_sync(kFull, ekey);
  const unsigned fresh_lanes = __ballot_sync(kFull, fresh);
  const int umax = __reduce_max_sync(epeers, u);
  if (ekey >= 0 && lane == __ffs(epeers) - 1) {
    const int n_fresh = __popc(fresh_lanes & epeers);
    if (n_fresh) atomicAdd(&n_photons[ekey], static_cast<unsigned long long>(n_fresh));
    atomicMax(&win_cur[ekey], umax);
  }

  // the block that counted in last advances the turn for the next launch
  if (threadIdx.x == 0 && n_counted == gridDim.x - 1) {
    cuda::atomic_thread_fence(cuda::memory_order_acquire,
                              cuda::thread_scope_device);
    counted.store(0u, cuda::memory_order_relaxed);
    turn_ref.store((turn + 1u) % 3u, cuda::memory_order_relaxed);
  }
}

}  // namespace

// energy_sum (n_dust, n_cells) f32; n_photons (n_cells,) int64;
// last_uid (n_cells + 1,) int32; win (3, n_cells + 1) int32, the scratch
// tables, INT_MIN where untouched; state (2,) int32, the turn and the count of
// finished blocks, both 0 at the start; cell_dep, enter (B,) int64; uid (B,)
// int32; dep (B, n_dust) f32. n_dust may be 0 (visits only) and B may be 0
// (commit only). Returns the cudaError_t of the launch (0 on success).
extern "C" int deposit_visit(float* energy_sum, long long* n_photons,
                             int* last_uid, int* win, int* state,
                             const long long* cell_dep, const float* dep,
                             const long long* enter, const int* uid,
                             int n_dust, int n_cells, int B,
                             cudaStream_t stream) {
  const int n = B > n_cells ? B : n_cells;
  if (n <= 0) return 0;
  deposit_visit_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      energy_sum, reinterpret_cast<unsigned long long*>(n_photons), last_uid,
      win, reinterpret_cast<unsigned*>(state), cell_dep, dep, enter, uid,
      n_dust, n_cells, B);
  return static_cast<int>(cudaGetLastError());
}
