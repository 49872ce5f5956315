// The device-side loop of a captured CUDA graph: a WHILE conditional
// node whose body is captured from a second stream, and the one-thread
// kernel that sets the node's condition from a flag on the card.
//
// Replaces the XLA lax.while_loop of acmpc_tpu/qp/admm.py:469-523 (the
// QP's chunk loop, `~done & it < max_iter` evaluated on the device): no
// Pallas kernel. Eagerly the port reads the flag back once a chunk; in a
// graph the card decides by itself whether the body runs again.
//
// What bounds it on this card. The kernel reads one byte and adds to one
// 8-byte counter: nanoseconds of memory traffic. Its cost is a launch of
// one thread inside the graph plus the conditional node's re-launch of
// its body, a few microseconds a trip, against a host read a trip when
// the loop runs eagerly (a stream synchronisation and the interpreter's
// turn before the next chunk is queued).
//
// How a loop is captured (graph_loop_begin, then the body on the second
// stream, then graph_loop_end), while the first stream is capturing:
//  1. cudaStreamGetCaptureInfo reaches the graph being captured;
//  2. cudaGraphConditionalHandleCreate makes the node's handle, with a
//     default of 1 ("run") assigned at each launch of the graph;
//  3. the kernel, captured on the first stream, sets the handle from the
//     flag of the carry as it enters the loop (JAX tests the condition
//     before the first trip);
//  4. the WHILE node is added after the kernel, and the first stream's
//     capture continues after the node;
//  5. cudaStreamBeginCaptureToGraph points the second stream at the
//     node's body graph. The caller captures the body there and ends it
//     with graph_loop_end: the kernel again, now also counting the trip,
//     then cudaStreamEndCapture.
// Needs CUDA 12.4 or later, in the toolkit and in the driver.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "graph_loop.cu needs CUDA 12.4 or later: conditional WHILE nodes"
#endif

namespace {

// Sets the loop's condition to *flag; with `trips`, counts one trip of
// the body (a running total, read by the caller's launch accounting).
__global__ void graph_loop_set_condition(cudaGraphConditionalHandle handle,
                                         const bool* flag,
                                         long long* trips) {
  if (trips != nullptr) *trips += 1;
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t stream, cudaStreamCaptureStatus* status,
                         cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps,
                                  nullptr, n_deps);
#else
  return cudaStreamGetCaptureInfo(stream, status, nullptr, graph, deps,
                                  n_deps);
#endif
}

}  // namespace

// The runtime's and the driver's CUDA versions (e.g. 12040 for 12.4);
// also loads the kernel, so that no module loads during a capture.
// Returns a CUDA error code.
extern "C" int graph_loop_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err == cudaSuccess) err = cudaDriverGetVersion(driver);
  cudaFuncAttributes attrs;
  if (err == cudaSuccess)
    err = cudaFuncGetAttributes(&attrs, graph_loop_set_condition);
  return (int)err;
}

// Steps 1-5 above on `stream` (capturing) and `body_stream` (idle);
// `mode` is the body capture's cudaStreamCaptureMode. Writes the
// node's handle. Returns a CUDA error code.
extern "C" int graph_loop_begin(void* stream, const bool* flag,
                                void* body_stream, int mode,
                                unsigned long long* handle_out) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = capture_info(s, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 1,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return (int)err;
  graph_loop_set_condition<<<1, 1, 0, s>>>(handle, flag, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = capture_info(s, &status, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, body, nullptr,
                                      nullptr, 0, (cudaStreamCaptureMode)mode);
  if (err != cudaSuccess) return (int)err;
  *handle_out = handle;
  return 0;
}

// Ends the body on `body_stream`: the kernel sets the condition from
// *flag (the carry after this trip) and adds one to *trips, then the
// body's capture ends. With a null `flag` the capture only ends (the
// body failed; the caller raises). Returns a CUDA error code.
extern "C" int graph_loop_end(void* body_stream, unsigned long long handle,
                              const bool* flag, long long* trips) {
  cudaStream_t b = (cudaStream_t)body_stream;
  cudaError_t launch = cudaSuccess;
  if (flag != nullptr) {
    graph_loop_set_condition<<<1, 1, 0, b>>>(handle, flag, trips);
    launch = cudaGetLastError();
  }
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(b, &body);
  return (int)(launch != cudaSuccess ? launch : err);
}
