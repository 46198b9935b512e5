// A device while loop inside a captured CUDA graph: the counterpart of
// jax.lax.while_loop (oasisx_tpu/fracstep.py:2969-3018, the inner max_iter
// loop; oasisx_tpu/la/krylov.py's cg, bicgstab, gmres and the batched
// solvers), for sm_90a.  It replaces no Pallas kernel: XLA ran those loops on
// the TPU without one.
//
// A loop is a conditional WHILE node (CUDA 12.4 and later) whose body graph
// is captured from a second stream.  oasisx_loop_open, called while the
// caller's stream is capturing:
//   1. creates the node's conditional handle in the graph being captured
//      (cudaStreamGetCaptureInfo gives the graph, the top-level one or the
//      body of an enclosing loop);
//   2. captures set_cond_kernel, which sets the handle from the loop's first
//      condition, a bool the caller computed on the device;
//   3. adds the WHILE node after it and makes the node the stream's only
//      dependency, so that what the caller captures next runs after the loop;
//   4. starts capturing the body stream into the node's body graph.
// The caller then captures the body on the body stream;
// oasisx_loop_close captures set_cond_kernel once more, from the condition
// the body computed at its end, and ends the body's capture.  A trip of the
// body thus ends by deciding whether another one runs: the loop reads nothing
// on the host.
//
// set_cond_kernel is one thread reading one byte: bound by its launch, about
// the cost of a graph node (a few microseconds a trip), against a host read of
// the condition on the eager path (a synchronisation a trip).

#include <cuda_runtime.h>

namespace {

__global__ void set_cond_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

cudaError_t capture_info(cudaStream_t s, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, nullptr, ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, ndeps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess
                                                 : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" {

// The loop's opening: the stream ``stream`` must be capturing; ``flag`` is a
// device bool (the first condition); the handle is written to ``handle_out``
// (a host unsigned long long) for oasisx_loop_close.  On return
// ``body_stream`` captures into the node's body graph.
int oasisx_loop_open(void* stream, void* body_stream, void* flag, void* handle_out) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info(s, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_cond_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(flag));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(s, &graph, &deps, &ndeps);  // the set-up kernel's node
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  err = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                      params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                      cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return err;
  *static_cast<unsigned long long*>(handle_out) = handle;
  return cudaSuccess;
}

// The end of the body: the condition ``flag`` (a device bool the body
// computed) sets the handle, and the body's capture ends.
int oasisx_loop_close(void* body_stream, void* flag, long long handle) {
  cudaStream_t b = static_cast<cudaStream_t>(body_stream);
  set_cond_kernel<<<1, 1, 0, b>>>(static_cast<cudaGraphConditionalHandle>(handle),
                                  static_cast<const bool*>(flag));
  cudaError_t launch = cudaGetLastError();
  cudaGraph_t body;
  cudaError_t err = cudaStreamEndCapture(b, &body);
  return launch != cudaSuccess ? launch : err;
}

// A body whose capture failed on the host: end the body stream's capture, if
// it is still capturing, so that the stream can be used again.
int oasisx_loop_abort(void* body_stream) {
  cudaStream_t b = static_cast<cudaStream_t>(body_stream);
  cudaStreamCaptureStatus status;
  cudaError_t err = cudaStreamIsCapturing(b, &status);
  if (err != cudaSuccess || status == cudaStreamCaptureStatusNone) return err;
  cudaGraph_t body;
  err = cudaStreamEndCapture(b, &body);
  cudaGetLastError();  // an invalidated capture's error is the caller's, not this call's
  return err == cudaErrorStreamCaptureInvalidated ? cudaSuccess : err;
}

}  // extern "C"
