// cond_node: IF conditional nodes in a CUDA graph under stream capture, for
// Hopper (sm_90a; conditional nodes need CUDA 12.4 or later).
//
// Replaces no Pallas kernel. It is the port's form of jax.lax.cond inside the
// JAX package's device-resident loops (hyperion_tpu/transport/engine.py, the
// Lucy step's refill and MRW branches): while a stream captures a graph,
// cond_begin adds to that graph a one-thread kernel that copies a () bool
// device tensor into a new conditional handle, and after it an IF node whose
// body runs in a replay only when the handle is set. The capturing stream
// goes on after the node; a stream of this library's own (cond_stream)
// captures the body into the node's graph until cond_end. engine.run_if
// drives the calls and routes the body's allocations into the parent
// graph's memory pool.
//
// What bounds it: launch latency. A node moves 1 byte: one launch of one
// thread and the node's own scheduling on the device, whatever the body
// holds (PERF.md gives the measured cost a node).

#include <cuda_runtime.h>

namespace {

__global__ void set_if(cudaGraphConditionalHandle handle, const bool* gate) {
  cudaGraphSetConditional(handle, *gate ? 1u : 0u);
}

}  // namespace

extern "C" {

// The calls return a cudaError_t (0 on success); -1 where `parent` is not
// capturing.
int cond_begin(cudaStream_t parent, cudaStream_t child, const bool* gate) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if<<<1, 1, 0, parent>>>(handle, gate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the node depends on what the stream has captured so far: the kernel
  err = cudaStreamGetCaptureInfo(parent, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(parent, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(child, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeGlobal);
}

// Ends the capture of the body that cond_begin started on `child`.
int cond_end(cudaStream_t child) {
  cudaGraph_t body;
  return cudaStreamEndCapture(child, &body);
}

// A new non-blocking stream for the bodies' captures, in *stream; the
// caller keeps it for the process (a stream of PyTorch's pool may be the
// one that captures the graph).
int cond_stream(cudaStream_t* stream) {
  return cudaStreamCreateWithFlags(stream, cudaStreamNonBlocking);
}

}  // extern "C"
