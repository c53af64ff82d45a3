// voronoi_locate: the cell of a Voronoi grid that owns each point, for Hopper
// (sm_90a).
//
// Replaces hyperion_tpu/transport/gtable_voronoi.py:49-82,
// VoronoiGeometry._owner_walk with _lattice_start, which is not a Pallas
// kernel but an XLA fori_loop of walk_steps steps over the whole batch, each
// a (B, K) gather of neighbours, a (B, K, 3) gather of sites, the squared
// distances, an argmin and three selects. The Lucy step calls it on every
// lane at every step (the relocation after an interaction), and the imaging
// and monochromatic steps and raytracing call it too; in eager PyTorch it
// would be ~15 launches a step of the walk.
//
// One thread per lane. locate: the lattice start, lookup[(k m + j) m + i]
// with each index ((p - lo) / (hi - lo) * m) truncated and clipped to
// [0, m - 1], then the walk; ESCAPED (-1) outside the closed box. walk_from:
// the walk from the given cells (the trials of a position in a cell). A step
// reads the current cell's neighbour row up to its first -1 (the build packs
// the neighbours at the front), computes d2 = (s_x - x)^2 + (s_y - y)^2 +
// (s_z - z)^2 in the lanes' type for each, keeps the nearest with the first
// index winning ties, and moves only if it is strictly nearer than the
// current site: the plain walk (hyperion_tpu_torch/transport/
// voronoi_locate.py) step for step. A step that does not move leaves the
// state as it was, so a lane stops there; walk_steps caps the walk. The
// lanes whose last allowed step still moved are counted on the device
// (at_cap). The library is built with -fmad=false, so that the float32 and
// float64 sums are the plain version's bits (a fused multiply-add would
// round once where PyTorch's separate element-wise kernels round twice).
//
// The sites (n, 3) in the lanes' type and the int32 neighbour table (n, K)
// stay in global memory: at 50,000 sites they are 1.2 MB of float64 and
// ~7 MB of int32, which L2 holds. What bounds a call is the dependent chain
// of a step (a row of ids, then their sites, then the argmin) times the
// steps of the longest walk in a warp: a few steps from the lattice start.
// A simple, correct kernel: not tuned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
//        (hyperion_tpu_torch/transport/_build.py).
// One launch on the caller's stream; nothing here allocates or syncs.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kEscaped = -1;

template <typename L> struct Params {
  const L* sites;          // (n, 3)
  const int* neigh;        // (n, K), -1 padded
  const int* lookup;       // (m^3,), flat (k m + j) m + i
  const L* x;
  const L* y;
  const L* z;
  const long long* start;  // (B,) or null: locate from the lattice
  long long* out;          // (B,)
  unsigned long long* at_cap;
  L lo[3], hi[3];
  int K, m, walk_steps, B;
};

template <typename L>
__device__ __forceinline__ L dist2(const L* sites, long long c, L x, L y,
                                   L z) {
  const L dx = __ldg(sites + 3 * c) - x;
  const L dy = __ldg(sites + 3 * c + 1) - y;
  const L dz = __ldg(sites + 3 * c + 2) - z;
  return dx * dx + dy * dy + dz * dz;
}

// The lattice index along one axis: trunc((p - lo) / (hi - lo) * m) clipped
// to [0, m - 1] (p inside the box, so the quotient is in [0, m]).
template <typename L>
__device__ __forceinline__ int lattice_index(L p, L lo, L hi, int m) {
  int i = static_cast<int>((p - lo) / (hi - lo) * static_cast<L>(m));
  return i < 0 ? 0 : (i > m - 1 ? m - 1 : i);
}

template <typename L>
__global__ void __launch_bounds__(kThreads) locate_kernel(const Params<L> p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.B) return;
  const L x = p.x[i], y = p.y[i], z = p.z[i];
  long long cur;
  if (p.start != nullptr) {
    cur = p.start[i];
  } else {
    const bool inside = x >= p.lo[0] && x <= p.hi[0] && y >= p.lo[1] &&
                        y <= p.hi[1] && z >= p.lo[2] && z <= p.hi[2];
    if (!inside) {
      p.out[i] = kEscaped;
      return;
    }
    const int a = lattice_index(x, p.lo[0], p.hi[0], p.m);
    const int b = lattice_index(y, p.lo[1], p.hi[1], p.m);
    const int c = lattice_index(z, p.lo[2], p.hi[2], p.m);
    cur = __ldg(p.lookup + (c * p.m + b) * p.m + a);
  }
  L d2c = dist2(p.sites, cur, x, y, z);
  bool moved = false;
  for (int step = 0; step < p.walk_steps; ++step) {
    const int* row = p.neigh + cur * p.K;
    L best = L(0);
    long long nb_best = -1;
    for (int j = 0; j < p.K; ++j) {
      const int nb = __ldg(row + j);
      if (nb < 0) break;
      const L d2 = dist2(p.sites, nb, x, y, z);
      if (nb_best < 0 || d2 < best) {
        best = d2;
        nb_best = nb;
      }
    }
    moved = nb_best >= 0 && best < d2c;
    if (!moved) break;
    cur = nb_best;
    d2c = best;
  }
  p.out[i] = cur;
  if (moved) atomicAdd(p.at_cap, 1ull);
}

template <typename L>
int launch(const void* sites, const int* neigh, int K, const int* lookup,
           int m, const double box[6], int walk_steps, const void* x,
           const void* y, const void* z, const long long* start,
           long long* out, unsigned long long* at_cap, int B,
           cudaStream_t stream) {
  Params<L> p;
  p.sites = static_cast<const L*>(sites);
  p.neigh = neigh;
  p.lookup = lookup;
  p.x = static_cast<const L*>(x);
  p.y = static_cast<const L*>(y);
  p.z = static_cast<const L*>(z);
  p.start = start;
  p.out = out;
  p.at_cap = at_cap;
  for (int a = 0; a < 3; ++a) {
    // the box's values in the lanes' type, exactly (they came from it)
    p.lo[a] = static_cast<L>(box[a]);
    p.hi[a] = static_cast<L>(box[3 + a]);
  }
  p.K = K;
  p.m = m;
  p.walk_steps = walk_steps;
  p.B = B;
  const int blocks = (B + kThreads - 1) / kThreads;
  locate_kernel<L><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One call: is_double selects float64 over float32 for the sites, the box
// and the lanes; sites (n, 3), neigh (n, K) int32 (-1 padded), lookup (m^3,)
// int32, the box (lo_x, lo_y, lo_z, hi_x, hi_y, hi_z), walk_steps, the lanes
// x, y, z (B,), start (B,) int64 or 0 (locate from the lattice, ESCAPED
// outside the box), out (B,) int64, at_cap a uint64 device counter that gets
// one per lane whose last allowed step still moved. Device pointers but the
// box. Returns the cudaError_t of the launch (0 on success).
extern "C" int voronoi_locate(int is_double, const void* sites,
                              const int* neigh, int K, const int* lookup,
                              int m, double lo_x, double lo_y, double lo_z,
                              double hi_x, double hi_y, double hi_z,
                              int walk_steps, const void* x, const void* y,
                              const void* z, const long long* start,
                              long long* out, unsigned long long* at_cap,
                              int B, cudaStream_t stream) {
  if (B <= 0) return 0;
  const double box[6] = {lo_x, lo_y, lo_z, hi_x, hi_y, hi_z};
  return is_double
             ? launch<double>(sites, neigh, K, lookup, m, box, walk_steps, x,
                              y, z, start, out, at_cap, B, stream)
             : launch<float>(sites, neigh, K, lookup, m, box, walk_steps, x,
                             y, z, start, out, at_cap, B, stream);
}
