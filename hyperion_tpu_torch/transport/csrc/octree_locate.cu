// octree_locate: the leaf of an octree grid that holds each point, and the
// exit from a leaf's box with the leaf beyond it, for Hopper (sm_90a).
//
// Replaces hyperion_tpu/transport/gtable_octree.py:42-57,
// OctreeGeometry._descend, which is not a Pallas kernel but an XLA fori_loop
// of max_depth steps over the whole batch (a gather of the node's centre,
// the octant, a gather of the child and a select a level), with its callers
// find_cell (:59-71) and find_wall (:73-107). The Lucy, imaging and
// monochromatic steps call find_wall on every lane at every step and
// find_cell again for the relocation after an interaction (and in the
// refill and the MRW move where their gates open); in eager PyTorch a call
// was ~215 launches.
//
// find_cell: ESCAPED (-1) outside the root's box (a point on a face belongs
// to the grid unless its direction leaves through that face), else the
// descend from the root: at each refined node the octant by the node's
// centre planes, a point on a plane going to the side its direction moves
// towards (upper: the upper side for a direction along the plane). The
// plain version (hyperion_tpu_torch/transport/octree_locate.py
// find_cell_reference) does the same.
//
// find_wall: the exit from the leaf's box, in the lanes' type: on each axis
// the wall that the direction moves towards, t = max((wall - p) / k, 0)
// (finfo.max / 8 where k = 0), the least of the three (the first axis among
// equals), the landing point p + t k with the crossed coordinate set to the
// wall, and the leaf that holds it by find_cell's rule: the descend from the
// root, so that the next leaf is the plain version's by construction. The
// arithmetic is the plain version's element-wise ops one by one (this
// library is built with -fmad=false, so a * b + c rounds twice as PyTorch's
// separate kernels do; min and max are fmin and fmax behind PyTorch's NaN
// checks), so t, the axis, the wall and the next leaf are its bits.
//
// Types: the lanes are float32 (the engine on the card) or float64; the node
// records (gtable_octree.py node_records) are float64 and hold the tables'
// centres and walls exactly, so a coordinate is compared with them after
// widening, which is exact, and a wall is narrowed to the lanes' type
// exactly.
//
// What bounds it on this card: a call on 131,072 float32 lanes moves 4.2 MB
// (find_cell: six lanes in, the leaf out) or 7.3 MB (find_wall: the cell
// and six lanes in, four outputs), 1.3 or 2.2 us at 3.35 TB/s, and does a few
// tens of operations a lane. The records (128 bytes a node, 1.6 MB for
// config 4's 12,377 nodes) stay in L2, and the upper levels in L1. Its time
// is the chain of dependent record reads, one a level (8 on config 4). The
// design: one thread a lane; a level reads the node's centre, parent word,
// leaf mask and 8 children (the record's first 64 bytes, four 16-byte loads
// issued together), so each level is one wait; the leaf's walls are one
// more read in find_wall. Nothing is staged in shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -fmad=false
//        (hyperion_tpu_torch/transport/_build.py).
// One launch on the caller's stream; nothing here allocates or syncs, so a
// call captures in a CUDA graph and in a conditional node's body.

#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr long long kEscaped = -1;
// the words of a node record (gtable_octree.py RECORD_WORDS): words 0-2 the
// centre; word 3 as int32: the parent and the mask of the children that are
// leaves; words 4-7 as int32: the 8 children; words 8-13 lo and hi
constexpr int kRecordWords = 16;
constexpr int kWalls = 8;

template <typename L> struct Params {
  const double* rec;       // (n_nodes, kRecordWords)
  const L* x;
  const L* y;
  const L* z;
  const L* kx;
  const L* ky;
  const L* kz;
  const long long* cell;   // (B,): find_wall's leaves; null for find_cell
  long long* next;         // (B,)
  L* t;                    // (B,), find_wall only
  long long* ax;           // (B,), find_wall only
  L* wall;                 // (B,), find_wall only
  long long n_nodes;
  int depth;
  int B;
};

template <typename L> struct Big;
template <> struct Big<float> {
  static __device__ __forceinline__ float value() { return FLT_MAX / 8.0f; }
};
template <> struct Big<double> {
  static __device__ __forceinline__ double value() { return DBL_MAX / 8.0; }
};

// The side of a centre plane c that the point p with direction k belongs
// to: 1 above it, or on it moving up or along it (gtable_octree.py upper).
__device__ __forceinline__ int upper(double p, double c, double k) {
  return k < 0.0 ? (p > c ? 1 : 0) : (p >= c ? 1 : 0);
}

// Whether p is within [lo, hi] along one axis, a point on a face belonging
// to the grid unless its direction leaves through that face
// (gtable_octree.py OctreeGeometry._inside).
__device__ __forceinline__ bool within(double p, double k, double lo,
                                       double hi) {
  return (k > 0.0 ? p < hi : p <= hi) && (k < 0.0 ? p > lo : p >= lo);
}

__device__ __forceinline__ const double* record(const double* rec,
                                                long long n) {
  return rec + kRecordWords * n;
}

// torch.minimum and clamp_min on the card: NaN kept, else fmin / fmax.
template <typename L> __device__ __forceinline__ L tmin(L a, L b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmin(a, b);
}

template <typename L> __device__ __forceinline__ L clamp0(L a) {
  return a != a ? a : fmax(a, L(0));
}

// The leaf that holds the point (x, y, z) with direction (kx, ky, kz), or
// ESCAPED outside the root's box.
__device__ long long locate(const double* rec, int depth, double x, double y,
                            double z, double kx, double ky, double kz) {
  const double* root = rec + kWalls;
  const double2 w0 = __ldg(reinterpret_cast<const double2*>(root));
  const double2 w1 = __ldg(reinterpret_cast<const double2*>(root + 2));
  const double2 w2 = __ldg(reinterpret_cast<const double2*>(root + 4));
  if (!(within(x, kx, w0.x, w1.y) && within(y, ky, w0.y, w2.x) &&
        within(z, kz, w1.x, w2.y)))
    return kEscaped;
  int id = 0;
  for (int level = 0; level < depth; ++level) {
    // the record's first 64 bytes, four loads at once
    const double* r = record(rec, id);
    const double2 cxy = __ldg(reinterpret_cast<const double2*>(r));
    const int4 m = __ldg(reinterpret_cast<const int4*>(r + 2));
    const int4 ch0 = __ldg(reinterpret_cast<const int4*>(r + 4));
    const int4 ch1 = __ldg(reinterpret_cast<const int4*>(r + 6));
    const double cz = __hiloint2double(m.y, m.x);
    const int o = upper(x, cxy.x, kx) + 2 * upper(y, cxy.y, ky) +
                  4 * upper(z, cz, kz);
    const int4 q = (o & 4) ? ch1 : ch0;
    const int even = (o & 2) ? q.z : q.x;
    const int odd = (o & 2) ? q.w : q.y;
    const int child = (o & 1) ? odd : even;
    if ((m.w >> o) & 1) return child;
    id = child;
  }
  return id;  // the root when it is the only leaf (depth 0)
}

template <typename L>
__global__ void __launch_bounds__(kThreads) find_cell_kernel(
    const Params<L> p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p.B) return;
  p.next[i] = locate(p.rec, p.depth, p.x[i], p.y[i], p.z[i], p.kx[i],
                     p.ky[i], p.kz[i]);
}

// One axis of the box exit: the wall the direction moves towards and the
// distance to it, the plain version's ops in the lanes' type.
template <typename L>
__device__ __forceinline__ void axis(double lo, double hi, L p, L k, L& t,
                                     L& wall) {
  wall = static_cast<L>(k > L(0) ? hi : lo);
  const L d = clamp0((wall - p) / k);
  t = k != L(0) ? d : Big<L>::value();
}

template <typename L>
__global__ void __launch_bounds__(kThreads) find_wall_kernel(
    const Params<L> p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= p.B) return;
  long long c = p.cell[i];
  if (c < 0) c += p.n_nodes;  // PyTorch's indexing of a negative index
  const double* r = record(p.rec, c) + kWalls;
  const double2 w0 = __ldg(reinterpret_cast<const double2*>(r));
  const double2 w1 = __ldg(reinterpret_cast<const double2*>(r + 2));
  const double2 w2 = __ldg(reinterpret_cast<const double2*>(r + 4));
  const L x = p.x[i], y = p.y[i], z = p.z[i];
  const L kx = p.kx[i], ky = p.ky[i], kz = p.kz[i];
  L t1, t2, t3, v1, v2, v3;
  axis<L>(w0.x, w1.y, x, kx, t1, v1);
  axis<L>(w0.y, w2.x, y, ky, t2, v2);
  axis<L>(w1.x, w2.y, z, kz, t3, v3);
  const L t = tmin(tmin(t1, t2), t3);
  const int ax = t == t1 ? 0 : (t == t2 ? 1 : 2);
  const L w = ax == 0 ? v1 : (ax == 1 ? v2 : v3);
  // the landing point in the lanes' type, snapped onto the crossed wall
  const L step_x = t * kx;
  const L step_y = t * ky;
  const L step_z = t * kz;
  L xe = x + step_x;
  L ye = y + step_y;
  L ze = z + step_z;
  if (ax == 0) xe = w;
  if (ax == 1) ye = w;
  if (ax == 2) ze = w;
  p.t[i] = t;
  p.ax[i] = ax;
  p.wall[i] = w;
  p.next[i] = locate(p.rec, p.depth, xe, ye, ze, kx, ky, kz);
}

template <typename L>
int launch(const double* rec, long long n_nodes, int depth, const void* x,
           const void* y, const void* z, const void* kx, const void* ky,
           const void* kz, const long long* cell, long long* next, void* t,
           long long* ax, void* wall, int B, cudaStream_t stream) {
  Params<L> p;
  p.rec = rec;
  p.x = static_cast<const L*>(x);
  p.y = static_cast<const L*>(y);
  p.z = static_cast<const L*>(z);
  p.kx = static_cast<const L*>(kx);
  p.ky = static_cast<const L*>(ky);
  p.kz = static_cast<const L*>(kz);
  p.cell = cell;
  p.next = next;
  p.t = static_cast<L*>(t);
  p.ax = ax;
  p.wall = static_cast<L*>(wall);
  p.n_nodes = n_nodes;
  p.depth = depth;
  p.B = B;
  const int blocks = (B + kThreads - 1) / kThreads;
  if (cell == nullptr)
    find_cell_kernel<L><<<blocks, kThreads, 0, stream>>>(p);
  else
    find_wall_kernel<L><<<blocks, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One call: is_double selects float64 over float32 for the lanes and the
// float outputs; rec the node records (n_nodes, kRecordWords) float64, depth
// the refinement levels below the root; the lanes x, y, z, kx, ky, kz (B,);
// cell (B,) int64 (find_wall) or 0 (find_cell); next (B,) int64 out, and
// for find_wall t (B,) and wall (B,) in the lanes' type and ax (B,) int64
// out (else 0). Device pointers. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int octree_locate(int is_double, const double* rec,
                             long long n_nodes, int depth, const void* x,
                             const void* y, const void* z, const void* kx,
                             const void* ky, const void* kz,
                             const long long* cell, long long* next, void* t,
                             long long* ax, void* wall, int B,
                             cudaStream_t stream) {
  if (B <= 0) return 0;
  return is_double
             ? launch<double>(rec, n_nodes, depth, x, y, z, kx, ky, kz, cell,
                              next, t, ax, wall, B, stream)
             : launch<float>(rec, n_nodes, depth, x, y, z, kx, ky, kz, cell,
                             next, t, ax, wall, B, stream);
}

// The words of a node record that the kernels read.
extern "C" int octree_locate_record_words() { return kRecordWords; }
