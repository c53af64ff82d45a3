// deposit_visit: one transport step's per-cell statistics, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel hyperion_tpu/transport/pallas_ops.py::deposit_visit
// (body _deposit_visit_kernel). For every lane i of a batch of B lanes:
//
//   energy_sum[d, cell_dep[i]] += dep[d, i]                  for every dust d
//   fresh[i] = last_uid[enter[i]] != uid[i]                  table read BEFORE this step
//   n_photons[enter[i]] += fresh[i]                          where enter[i] < n_cells
//   last_uid[c] = max{uid[i] : enter[i] == c}                where some lane entered c
//
// enter[i] == n_cells is the drop slot: the lane entered no cell. The last-uid
// update OVERWRITES an entered cell's uid with the largest uid that entered it
// in this step; it does not keep a running maximum over time (uids 5, 3, 5 in
// three steps leave 5 and count 3). So the step's maximum goes into the scratch
// table `win` (launch 1) and is committed to last_uid afterwards (launch 2);
// never atomicMax into last_uid itself.
//
// What bounds it on this card: scattered 4-byte atomics, and about
// 4 * (n_dust + 3) * B bytes of lane reads. The atomics contend on the source's
// cell right after each refill, where many fresh packets deposit into one cell.
// Masked lanes carry dep == 0 and skip their atomic, which is numerically
// identical and spares that cell. Lanes in the drop slot touch no table.
// Making it fast is later work: warp-aggregated atomics for lanes of equal
// cell, and fusing it into a persistent step kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (hyperion_tpu_torch/transport/_build.py).
// Both launches run on the caller's stream; nothing here allocates or syncs.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void deposit_visit_lanes(float* __restrict__ energy_sum,
                                    unsigned long long* __restrict__ n_photons,
                                    const int* __restrict__ last_uid,
                                    int* __restrict__ win,
                                    const int* __restrict__ cell_dep,
                                    const float* __restrict__ dep,
                                    const int* __restrict__ enter,
                                    const int* __restrict__ uid,
                                    int n_dust, int n_cells, int B) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int cd = cell_dep[i];
  if (cd >= 0 && cd < n_cells) {
    for (int d = 0; d < n_dust; ++d) {
      const float v = dep[(size_t)d * B + i];
      if (v != 0.0f) atomicAdd(&energy_sum[(size_t)d * n_cells + cd], v);
    }
  }
  const int c = enter[i];
  if (c >= 0 && c < n_cells) {
    const int u = uid[i];
    // counts are non-negative, so the unsigned add is the int64 add
    if (last_uid[c] != u) atomicAdd(&n_photons[c], 1ULL);
    atomicMax(&win[c], u);
  }
}

__global__ void deposit_visit_commit(int* __restrict__ last_uid,
                                     int* __restrict__ win, int n_cells) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int w = win[c];
  if (w != INT_MIN) {
    last_uid[c] = w;
    win[c] = INT_MIN;
  }
}

}  // namespace

// energy_sum (n_dust, n_cells) f32; n_photons (n_cells,) int64;
// last_uid and win (n_cells + 1,) int32, win held at INT_MIN between calls;
// cell_dep, enter, uid (B,) int32; dep (n_dust, B) f32.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int deposit_visit(float* energy_sum, long long* n_photons,
                             int* last_uid, int* win, const int* cell_dep,
                             const float* dep, const int* enter,
                             const int* uid, int n_dust, int n_cells, int B,
                             cudaStream_t stream) {
  if (B > 0) {
    deposit_visit_lanes<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                          stream>>>(
        energy_sum, reinterpret_cast<unsigned long long*>(n_photons),
        last_uid, win, cell_dep, dep, enter, uid, n_dust, n_cells, B);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_cells > 0) {
    deposit_visit_commit<<<(n_cells + kThreads - 1) / kThreads, kThreads, 0,
                           stream>>>(last_uid, win, n_cells);
  }
  return static_cast<int>(cudaGetLastError());
}
