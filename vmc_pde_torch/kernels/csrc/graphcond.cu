// A conditional IF node inside a stream capture, for the device-side
// retry loop of the adaptive steppers' batched steps (solver/graphs.py).
//
// Replaces no TPU kernel: the JAX package keeps the retry loop of
// TDVP._adaptive_multi_impl in a lax.while_loop inside the step program.
// Here the step is a captured CUDA graph, and each retry slot is an IF
// node whose body (the attempt) runs only when a device flag is set.
//
// cond_if_begin, on a stream that is capturing: creates a conditional
// handle on the capturing graph, captures a one-thread kernel that sets
// the handle from the flag's byte (nonzero: run the body), adds the IF
// node after it, makes the node the stream's capture dependency and
// starts capturing ``body_stream`` into the node's body graph. cond_end
// ends that capture. Everything the body captures runs at replay only
// when the flag, as the graph finds it at that point, is nonzero. CUDA
// 12.3 or later.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const unsigned char* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

extern "C" int cond_if_begin(void* stream, void* body_stream,
                             const void* flag) {
  const cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t e =
      cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                       cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return (int)e;
  set_condition<<<1, 1, 0, s>>>(handle,
                                static_cast<const unsigned char*>(flag));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body_stream, params.conditional.phGraph_out[0], nullptr,
      nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int cond_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

// A stream of a program's own (non-blocking), which nothing else in the
// process uses: the libraries' per-stream workspaces on it are made by the
// program's eager warm-up, never inside its capture.
extern "C" int stream_create(void** out) {
  cudaStream_t s;
  const cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = e == cudaSuccess ? (void*)s : nullptr;
  return (int)e;
}

extern "C" int stream_destroy(void* stream) {
  return (int)cudaStreamDestroy((cudaStream_t)stream);
}
