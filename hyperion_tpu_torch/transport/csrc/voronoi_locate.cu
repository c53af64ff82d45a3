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
// locate: the lattice start, lookup[(k m + j) m + i] with each index ((p -
// lo) / (hi - lo) * m) truncated and clipped to [0, m - 1], then the walk;
// ESCAPED (-1) outside the closed box. walk_from: the walk from the given
// cells (the trials of a position in a cell). A step reads the current
// cell's neighbours, computes d2 = (s_x - x)^2 + (s_y - y)^2 + (s_z - z)^2
// in the lanes' type for each, keeps the nearest with the first index
// winning ties, and moves only if it is strictly nearer than the current
// site: the plain walk (hyperion_tpu_torch/transport/voronoi_locate.py)
// step for step. A step that does not move leaves the state as it was, so
// a lane stops there; walk_steps caps the walk. The lanes whose last
// allowed step still moved are counted on the device (at_cap). The library
// is built with -fmad=false, so that the float32 and float64 sums are the
// plain version's bits (a fused multiply-add would round once where
// PyTorch's separate element-wise kernels round twice).
//
// What bounds it on this card: a call's bytes and operations are a few MB
// and some tens of Mflop, a microsecond or two; its time is the chain of
// dependent reads of its slowest lanes (a Lucy call's lanes read 2.2 rows of
// ~15.8 neighbours each). The design:
//
// - The rows packed end to end (gtable_voronoi.py packed_rows), in the
//   lanes' type: a step reads one run of entries, each the neighbour's
//   site and its (id, row offset), and no read waits on an id; the winner's
//   entry gives the next row. A step's first kChunk entries are read with
//   the row's end, before its length is known (the tables hold kRowPad
//   zero entries past their last), and the rest kChunk at a time, each
//   chunk's loads together: a row of at most kChunk neighbours is one wait.
// - Each lane takes a group of kGroup (4) threads of one warp: each
//   thread takes every kGroup-th entry, and the group's argmin is a
//   shuffle reduction on (d2, index) in which the smaller index wins ties,
//   the sequential rule exactly. The group's threads then hold the same
//   state and stop together. More threads a lane put more of a row's reads
//   in flight at once; 4 was the fastest of 1, 2, 4 and 8 on both the Lucy
//   calls (131,072 lanes) and the positions calls (524,288) (PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
//        (hyperion_tpu_torch/transport/_build.py).
// One launch on the caller's stream; nothing here allocates or syncs.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kEscaped = -1;
// the threads of a lane (a power of two at most kChunk)
constexpr int kGroup = 4;
// the entries of a row that a lane's group reads at a time (the first
// chunk before the row's length is known), and the zero entries that the
// packed tables hold past their last (gtable_voronoi.py ROW_PAD, which the
// wrapper checks)
constexpr int kChunk = 8;
constexpr int kRowPad = 16;
static_assert(kChunk <= kRowPad, "a row's first chunk must stay inside the "
                                 "packed tables");
// no neighbour yet
constexpr int kNone = INT_MAX;

template <typename L> struct Params {
  const L* sites;          // (n, 3)
  const L* row_sites;      // (E + kRowPad, 3): each entry's neighbour's site
  const int2* meta;        // (E + kRowPad,): each entry's (neighbour, offset)
  const int* off;          // (n + 1,): row i is entries off[i]..off[i + 1]
  const int* lookup;       // (m^3,), flat (k m + j) m + i
  const L* x;
  const L* y;
  const L* z;
  const long long* start;  // (B,) or null: locate from the lattice
  long long* out;          // (B,)
  unsigned long long* at_cap;
  L lo[3], hi[3];
  int m, walk_steps, B;
};

template <typename L>
__device__ __forceinline__ L dist2(L sx, L sy, L sz, L x, L y, L z) {
  const L dx = sx - x;
  const L dy = sy - y;
  const L dz = sz - z;
  return dx * dx + dy * dy + dz * dz;
}

// The lattice index along one axis: trunc((p - lo) / (hi - lo) * m) clipped
// to [0, m - 1] (p inside the box, so the quotient is in [0, m]).
template <typename L>
__device__ __forceinline__ int lattice_index(L p, L lo, L hi, int m) {
  int i = static_cast<int>((p - lo) / (hi - lo) * static_cast<L>(m));
  return i < 0 ? 0 : (i > m - 1 ? m - 1 : i);
}

// One lane per group of G threads (G divides 32 and kThreads, so a group
// lies in one warp and one block and leaves or stays whole).
template <typename L>
__global__ void __launch_bounds__(kThreads) locate_kernel(const Params<L> p) {
  constexpr int G = kGroup;
  constexpr int kPer = kChunk / G;  // a thread's entries of a chunk
  static_assert(kPer * G == kChunk, "G must divide kChunk");
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long i = tid / G;
  const int t = static_cast<int>(tid % G);
  if (i >= p.B) return;
  const unsigned group = ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
  const L x = p.x[i], y = p.y[i], z = p.z[i];
  long long cur;
  if (p.start != nullptr) {
    cur = p.start[i];
  } else {
    const bool inside = x >= p.lo[0] && x <= p.hi[0] && y >= p.lo[1] &&
                        y <= p.hi[1] && z >= p.lo[2] && z <= p.hi[2];
    if (!inside) {
      if (t == 0) p.out[i] = kEscaped;
      return;
    }
    const int a = lattice_index(x, p.lo[0], p.hi[0], p.m);
    const int b = lattice_index(y, p.lo[1], p.hi[1], p.m);
    const int c = lattice_index(z, p.lo[2], p.hi[2], p.m);
    cur = __ldg(p.lookup + (c * p.m + b) * p.m + a);
  }
  int off = __ldg(p.off + cur);
  L d2c = dist2(__ldg(p.sites + 3 * cur), __ldg(p.sites + 3 * cur + 1),
                __ldg(p.sites + 3 * cur + 2), x, y, z);
  bool moved = false;
  for (int step = 0; step < p.walk_steps; ++step) {
    // this thread's entries of the row: t, t + G, t + 2G, ...; the first
    // chunk's read with the row's end
    const L* es = p.row_sites + 3LL * off;
    const int2* em = p.meta + off;
    L sx[kPer], sy[kPer], sz[kPer];
    int2 mm[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int j = t + G * u;
      sx[u] = __ldg(es + 3 * j);
      sy[u] = __ldg(es + 3 * j + 1);
      sz[u] = __ldg(es + 3 * j + 2);
      mm[u] = __ldg(em + j);
    }
    const int deg = __ldg(p.off + cur + 1) - off;
    // the thread's nearest: the first of the least
    L best = L(0);
    int jb = kNone;
    int2 mb = make_int2(0, 0);
    for (int j0 = 0;; j0 += kChunk) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int j = j0 + t + G * u;
        if (j < deg) {
          const L d2 = dist2(sx[u], sy[u], sz[u], x, y, z);
          if (jb == kNone || d2 < best) {
            best = d2;
            jb = j;
            mb = mm[u];
          }
        }
      }
      if (j0 + kChunk >= deg) break;
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int j = j0 + kChunk + t + G * u;
        if (j < deg) {
          sx[u] = __ldg(es + 3 * j);
          sy[u] = __ldg(es + 3 * j + 1);
          sz[u] = __ldg(es + 3 * j + 2);
          mm[u] = __ldg(em + j);
        }
      }
    }
    if (G > 1) {
      // the group's nearest: the least d2, the smaller index among equals
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) {
        const L bo = __shfl_xor_sync(group, best, o, G);
        const int jo = __shfl_xor_sync(group, jb, o, G);
        if (jo != kNone &&
            (jb == kNone || bo < best || (bo == best && jo < jb))) {
          best = bo;
          jb = jo;
        }
      }
      // the winner's entry, from the thread that read it
      const int owner = jb == kNone ? 0 : jb % G;
      mb.x = __shfl_sync(group, mb.x, owner, G);
      mb.y = __shfl_sync(group, mb.y, owner, G);
    }
    moved = jb != kNone && best < d2c;
    if (!moved) break;
    cur = mb.x;
    off = mb.y;
    d2c = best;
  }
  if (t == 0) {
    p.out[i] = cur;
    if (moved) atomicAdd(p.at_cap, 1ull);
  }
}

template <typename L>
int launch(const void* sites, const void* row_sites, const int* meta,
           const int* off, const int* lookup, int m, const double box[6],
           int walk_steps, const void* x, const void* y, const void* z,
           const long long* start, long long* out,
           unsigned long long* at_cap, int B, cudaStream_t stream) {
  Params<L> p;
  p.sites = static_cast<const L*>(sites);
  p.row_sites = static_cast<const L*>(row_sites);
  p.meta = reinterpret_cast<const int2*>(meta);
  p.off = off;
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
  p.m = m;
  p.walk_steps = walk_steps;
  p.B = B;
  const long long threads = static_cast<long long>(B) * kGroup;
  const int blocks = static_cast<int>((threads + kThreads - 1) / kThreads);
  locate_kernel<L><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One call: is_double selects float64 over float32 for the sites, the box
// and the lanes; sites (n, 3), the packed rows (row_sites (E + kRowPad, 3)
// in the sites' type, meta (E + kRowPad, 2) int32, off (n + 1,) int32),
// lookup (m^3,) int32, the box (lo_x, lo_y, lo_z, hi_x, hi_y, hi_z),
// walk_steps, the lanes x, y, z (B,), start (B,) int64 or 0 (locate from
// the lattice, ESCAPED outside the box), out (B,) int64, at_cap a uint64
// device counter that gets one per lane whose last allowed step still
// moved. Device pointers but the box. Returns the cudaError_t of the launch (0 on success).
extern "C" int voronoi_locate(int is_double, const void* sites,
                              const void* row_sites, const int* meta,
                              const int* off, const int* lookup, int m,
                              double lo_x, double lo_y, double lo_z,
                              double hi_x, double hi_y, double hi_z,
                              int walk_steps, const void* x, const void* y,
                              const void* z, const long long* start,
                              long long* out, unsigned long long* at_cap,
                              int B, cudaStream_t stream) {
  if (B <= 0) return 0;
  const double box[6] = {lo_x, lo_y, lo_z, hi_x, hi_y, hi_z};
  return is_double
             ? launch<double>(sites, row_sites, meta, off, lookup, m, box,
                              walk_steps, x, y, z, start, out, at_cap, B,
                              stream)
             : launch<float>(sites, row_sites, meta, off, lookup, m, box,
                             walk_steps, x, y, z, start, out, at_cap, B,
                             stream);
}

// The zero entries that the packed tables must hold past their last.
extern "C" int voronoi_locate_row_pad() { return kRowPad; }
