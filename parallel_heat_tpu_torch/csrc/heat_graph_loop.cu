// heat_graph_loop — conditional nodes for the device loop
// (parallel_heat_tpu_torch/utils/device_loop.py).
//
// Replaces no TPU kernel. The JAX package keeps its loops on the device
// with lax.while_loop and lax.cond (parallel_heat_tpu/solver.py:301 and
// :309, parallel_heat_tpu/ops/multigrid.py:405); this is how the port
// does the same on the card: a body guarded by a flag in device memory
// runs, or is skipped, without the host reading the flag.
//
// PyTorch captures every piece of a loop's body as a graph of its own
// (a "segment": torch.cuda.CUDAGraph with keep_graph=True, all segments
// of one loop in one memory pool, so PyTorch's allocator serves the
// body's temporaries). This file assembles the segments into one graph:
// a chain in capture order, each segment a child-graph node, and each
// guarded body behind an IF node whose condition a one-thread kernel
// sets from the flag's byte just before it (CUDA 12.3 conditional
// nodes; nested bodies nest); a loop that must run to its flag's verdict
// in one graph (the V-cycles of an implicit step) is one body behind a
// WHILE node (CUDA 12.4), the condition kernel closing its body. A
// conditional body holds child graphs, kernels, memsets and copies of
// device memory only, as CUDA requires.
//
// Two entry points.
//
// heat_graph_loop(op, a, b, c, d, out) builds and runs the graphs, out
// an array of three handles:
//   kCreate       out[0] = a new empty graph
//   kAddChild     append a clone of graph c to graph a after node b
//                 (null: a root); out[0] = the new node
//   kAddIf        append to graph a after node b the condition kernel
//                 (reads the flag's byte at c) and an IF node on it;
//                 out[0] = the IF node, out[1] = its body graph
//   kAddWhile     the same with a WHILE node; out[2] = its condition's
//                 handle, which kCloseWhile needs
//   kCloseWhile   end WHILE body graph a (its last node b) with the
//                 condition kernel on flag c for handle d: the body runs
//                 again while the flag holds
//   kCount        out[0] = the number of nodes of graph a (its top level)
//   kInstantiate  out[0] = graph a instantiated
//   kUpload       upload the instantiated graph a on stream b
//   kLaunch       launch the instantiated graph a on stream b
//   kDestroy      destroy graph a
//   kDestroyExec  destroy the instantiated graph a
// Returns 0 or a cudaError_t.
//
// heat_graph_window(r, st, flag, ci, eps, full_steps, stream) closes a
// check window of the converge loop in one thread: st = {k, res} as
// doubles, k += ci, res = *r (a float32), flag = res >= eps && k <
// full_steps. A NaN residual clears the flag, as `while res >= eps`
// ends the JAX loop. Its plain version is the same four torch ops
// (device_loop.WindowLoop._close).

#include <cuda_runtime.h>

#include <cstdint>

__global__ void heat_graph_set_cond_kernel(cudaGraphConditionalHandle handle,
                                           const unsigned char* flag) {
  cudaGraphSetConditional(handle, *flag != 0 ? 1u : 0u);
}

__global__ void heat_graph_window_kernel(const float* r, double* st,
                                         unsigned char* flag, int ci,
                                         double eps, double full_steps) {
  const double res = static_cast<double>(*r);
  const double k = st[0] + ci;
  st[0] = k;
  st[1] = res;
  *flag = (res >= eps && k < full_steps) ? 1 : 0;
}

enum HeatGraphOp : int {
  kCreate = 0,
  kAddChild = 1,
  kAddIf = 2,
  kAddWhile = 3,
  kCloseWhile = 4,
  kCount = 5,
  kInstantiate = 6,
  kUpload = 7,
  kLaunch = 8,
  kDestroy = 9,
  kDestroyExec = 10,
};

// The condition kernel for `handle` on `flag`, after `dep` (or a root).
static cudaError_t heat_graph_add_set(cudaGraph_t graph, cudaGraphNode_t dep,
                                      cudaGraphConditionalHandle handle,
                                      const unsigned char* flag,
                                      cudaGraphNode_t* node) {
  void* args[] = {&handle, &flag};
  cudaKernelNodeParams kp{};
  kp.func = reinterpret_cast<void*>(heat_graph_set_cond_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, dep ? &dep : nullptr,
                                dep ? 1 : 0, &kp);
}

static cudaError_t heat_graph_add_cond(cudaGraph_t graph, cudaGraphNode_t dep,
                                       const unsigned char* flag,
                                       cudaGraphConditionalNodeType type,
                                       void** out) {
  cudaGraphConditionalHandle handle;
  cudaError_t err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t set;
  err = heat_graph_add_set(graph, dep, handle, flag, &set);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams cp{};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = type;
  cp.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, &set, 1, &cp);
  if (err != cudaSuccess) return err;
  out[0] = node;
  out[1] = cp.conditional.phGraph_out[0];
  out[2] = reinterpret_cast<void*>(static_cast<uintptr_t>(handle));
  return cudaSuccess;
}

extern "C" int heat_graph_loop(int op, void* a, void* b, void* c, void* d,
                               void** out) {
  cudaError_t err = cudaErrorInvalidValue;
  switch (op) {
    case kCreate: {
      cudaGraph_t g;
      err = cudaGraphCreate(&g, 0);
      if (err == cudaSuccess) out[0] = g;
      break;
    }
    case kAddChild: {
      cudaGraphNode_t dep = static_cast<cudaGraphNode_t>(b);
      cudaGraphNode_t node;
      err = cudaGraphAddChildGraphNode(&node, static_cast<cudaGraph_t>(a),
                                       dep ? &dep : nullptr, dep ? 1 : 0,
                                       static_cast<cudaGraph_t>(c));
      if (err == cudaSuccess) out[0] = node;
      break;
    }
    case kAddIf:
    case kAddWhile:
      if (c == nullptr) break;
      err = heat_graph_add_cond(
          static_cast<cudaGraph_t>(a), static_cast<cudaGraphNode_t>(b),
          static_cast<const unsigned char*>(c),
          op == kAddIf ? cudaGraphCondTypeIf : cudaGraphCondTypeWhile, out);
      break;
    case kCloseWhile: {
      if (c == nullptr) break;
      cudaGraphNode_t node;
      err = heat_graph_add_set(
          static_cast<cudaGraph_t>(a), static_cast<cudaGraphNode_t>(b),
          static_cast<cudaGraphConditionalHandle>(
              reinterpret_cast<uintptr_t>(d)),
          static_cast<const unsigned char*>(c), &node);
      if (err == cudaSuccess) out[0] = node;
      break;
    }
    case kCount: {
      size_t n = 0;
      err = cudaGraphGetNodes(static_cast<cudaGraph_t>(a), nullptr, &n);
      if (err == cudaSuccess) out[0] = reinterpret_cast<void*>(n);
      break;
    }
    case kInstantiate: {
      cudaGraphExec_t e;
      err = cudaGraphInstantiate(&e, static_cast<cudaGraph_t>(a), 0);
      if (err == cudaSuccess) out[0] = e;
      break;
    }
    case kUpload:
      err = cudaGraphUpload(static_cast<cudaGraphExec_t>(a),
                            static_cast<cudaStream_t>(b));
      break;
    case kLaunch:
      err = cudaGraphLaunch(static_cast<cudaGraphExec_t>(a),
                            static_cast<cudaStream_t>(b));
      break;
    case kDestroy:
      err = cudaGraphDestroy(static_cast<cudaGraph_t>(a));
      break;
    case kDestroyExec:
      err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(a));
      break;
    default:
      break;
  }
  return static_cast<int>(err);
}

extern "C" int heat_graph_window(const float* r, double* st,
                                 unsigned char* flag, int ci, double eps,
                                 double full_steps, void* stream) {
  if (r == nullptr || st == nullptr || flag == nullptr || ci < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  heat_graph_window_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      r, st, flag, ci, eps, full_steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* heat_graph_loop_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
