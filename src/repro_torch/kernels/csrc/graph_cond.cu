// Conditional nodes of a captured CUDA graph (CUDA 12.4+), for the
// serial GTG-Shapley estimator under the captured round
// (src/repro_torch/engine/graph_flow.py): one WHILE node runs the
// Monte-Carlo rounds, one IF node per walk step guards that step's
// utility evaluation.
//
// Replaces: no Pallas kernel.  The reference runs the estimator inside
// its scan as a `lax.while_loop` over MC rounds whose steps are
// `lax.cond`s (src/repro/core/shapley.py:85-150); XLA keeps that control
// flow on the device.  A CUDA graph is a fixed list of launches; these
// nodes are its only data-dependent control flow.
//
// set_condition_kernel: one thread reads a device bool and sets the
// node's condition with cudaGraphSetConditional.  It moves one byte, so
// its bound is the launch itself (a few microseconds inside a graph).
//
// The entries work on a stream that PyTorch is capturing: they read the
// capture's graph and dependencies, add the node there, move the stream
// past it and begin capturing a second stream into the node's body graph,
// where the caller's PyTorch code then runs (the caller routes that
// code's allocations to the capture's memory pool).  The caller counts
// the nodes it makes: on the H100 machine (driver 580, runtime 12.9)
// cudaGraphGetNodes / cudaGraphNodeGetType over a body graph that holds
// a conditional node returned cudaErrorUnknown.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// The graph `s` is capturing into and the stream's current dependencies.
cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, nullptr, n);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph,
                                             deps, n);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorIllegalState;
}

}  // namespace

// out: [runtime version, driver version], as CUDART_VERSION counts them.
extern "C" int graph_cond_versions(int64_t* out) {
  int runtime = 0, driver = 0;
  cudaError_t err = cudaRuntimeGetVersion(&runtime);
  if (err != cudaSuccess) return (int)err;
  err = cudaDriverGetVersion(&driver);
  if (err != cudaSuccess) return (int)err;
  out[0] = runtime;
  out[1] = driver;
  return 0;
}

// A non-blocking stream of the device's primary context, for capturing
// conditional bodies (never shared with PyTorch's stream pool).
extern "C" int graph_cond_stream(int64_t device, void** out) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamCreateWithFlags((cudaStream_t*)out,
                                        cudaStreamNonBlocking);
}

// Adds a conditional node (kind 0: IF, 1: WHILE) with one body to the
// graph `stream` is capturing, after the stream's dependencies, its
// condition set from *flag by a kernel just before it; moves the stream
// past the node and begins capturing `body_stream` into the body.
// out: [body graph, conditional handle].
extern "C" int graph_cond_begin(const void* flag, int64_t kind, int64_t mode,
                                int64_t device, void* stream,
                                void* body_stream, int64_t* out) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n;
  err = capture_info(s, &graph, &deps, &n);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_condition_kernel<<<1, 1, 0, s>>>(handle, (const bool*)flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_info(s, &graph, &deps, &n);     // now after the kernel
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = kind ? cudaGraphCondTypeWhile
                                 : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, body,
                                      nullptr, nullptr, 0,
                                      (cudaStreamCaptureMode)mode);
  if (err != cudaSuccess) return (int)err;
  out[0] = (int64_t)(intptr_t)body;
  out[1] = (int64_t)handle;
  return 0;
}

// Ends a body begun by graph_cond_begin.  With a `flag` (a WHILE), the
// body's last node sets the next pass's condition from *flag.  The
// capture is ended even when that launch failed.
extern "C" int graph_cond_end(int64_t handle, const void* flag,
                              int64_t device, void* body_stream) {
  cudaError_t err = cudaSetDevice((int)device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t b = (cudaStream_t)body_stream;
  cudaError_t launch = cudaSuccess;
  if (flag != nullptr) {
    set_condition_kernel<<<1, 1, 0, b>>>((cudaGraphConditionalHandle)handle,
                                         (const bool*)flag);
    launch = cudaGetLastError();
  }
  cudaGraph_t body = nullptr;
  err = cudaStreamEndCapture(b, &body);
  return (int)(launch != cudaSuccess ? launch : err);
}
