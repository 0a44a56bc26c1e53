// The reference's jax.lax.while_loop as one CUDA graph, for Hopper (sm_90a).
//
// Replaces the host's reading of a device loop's end test.  The reference
// runs three loops whose test never leaves the device:
//   rgk_tpu/integrator/path.py:417  the queued NEE eye walk,
//                                   cond = any(alive | s < s_end)
//   rgk_tpu/integrator/path.py:736  the queued BDPT eye walk, the same cond
//   rgk_tpu/integrator/path.py:849  the per-sample path,
//                                   w_cond = (bounce < depth) & any(alive)
// The port captures each loop's pieces as PyTorch CUDA graphs
// (torch.cuda.CUDAGraph(keep_graph=True), raw_cuda_graph()), each body
// writing its end test into a device flag.  rgk_while_graph_create builds
//   child(prologue) -> setter -> WHILE(handle) { child(body) -> setter }
//                   -> child(epilogue)
// and instantiates it: one launch runs the whole loop, with no read of the
// flag on the host and no body past the end.
//
// The condition setter is one of two kernels here: one thread reads the flag
// (a bool or an int32 the body wrote), sets the WHILE node's condition to
// it (cudaGraphSetConditional) and adds 1 to an int64 counter of its runs.
// A launch runs it once before the WHILE node and once after each body, so
// (runs - launches) is the bodies run.  What bounds it: nothing of the
// card's rates (1 + 8 bytes read, 8 written, two operations); it costs a
// kernel node's launch latency an iteration, which replaces a host read of
// the flag (a sync) every k replays.
//
// The phase stamp is the other one-thread kernel: it reads %globaltimer
// (the device's nanosecond clock), adds now - acc[last] into acc[slot] and
// sets acc[last] = now; a slot of -1 only marks.  Launched between the
// phases of a captured body, it times them on the device with no read on
// the host (integrator/graph.py sums the slots when its statistics are
// read).  What bounds it: a kernel node's launch latency; 32 bytes moved.
//
// A conditional body may hold kernel, memset, memcpy (device or pinned
// memory), empty and child graph nodes.  Every node of each captured graph
// is listed (child graphs walked) before building, and any other type
// (event record or wait, host, memory alloc or free, external semaphores,
// a memcpy touching pageable host memory or an array) is refused with its
// name.  The driver must be 12.4 or later (conditional WHILE nodes).
//
// Entry points return 0 or an error code; rgk_while_graph_error() then
// names what failed.

#include <cuda_runtime.h>

#include <cstdio>
#include <vector>

namespace {

constexpr int kMinDriver = 12040;  // conditional WHILE nodes

char g_error[512] = "";

int fail(int code, const char* what) {
  std::snprintf(g_error, sizeof(g_error), "%s", what);
  return code == 0 ? -1 : code;
}

int fail_cuda(cudaError_t err, const char* call) {
  std::snprintf(g_error, sizeof(g_error), "%s: %s (cudaError %d)", call,
                cudaGetErrorString(err), static_cast<int>(err));
  cudaGetLastError();
  return static_cast<int>(err);
}

#define RGK_TRY(call)                                  \
  do {                                                 \
    cudaError_t err_ = (call);                         \
    if (err_ != cudaSuccess) return fail_cuda(err_, #call); \
  } while (0)

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const void* flag, int flag_bytes,
                              long long* runs) {
  const unsigned int live =
      flag_bytes == 1 ? *static_cast<const unsigned char*>(flag) != 0
                      : *static_cast<const int*>(flag) != 0;
  cudaGraphSetConditional(handle, live);
  *runs += 1;
}

__global__ void stamp(long long* acc, int last, int slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long t = static_cast<long long>(now);
  if (slot >= 0) acc[slot] += t - acc[last];
  acc[last] = t;
}

const char* node_type_name(cudaGraphNodeType t) {
  switch (t) {
    case cudaGraphNodeTypeKernel: return "kernel";
    case cudaGraphNodeTypeMemcpy: return "memcpy";
    case cudaGraphNodeTypeMemset: return "memset";
    case cudaGraphNodeTypeHost: return "host";
    case cudaGraphNodeTypeGraph: return "child graph";
    case cudaGraphNodeTypeEmpty: return "empty";
    case cudaGraphNodeTypeWaitEvent: return "event wait";
    case cudaGraphNodeTypeEventRecord: return "event record";
    case cudaGraphNodeTypeExtSemaphoreSignal:
      return "external semaphore signal";
    case cudaGraphNodeTypeExtSemaphoreWait: return "external semaphore wait";
    case cudaGraphNodeTypeMemAlloc: return "memory alloc";
    case cudaGraphNodeTypeMemFree: return "memory free";
    case cudaGraphNodeTypeConditional: return "conditional";
    default: return "unknown";
  }
}

// A memcpy node may touch device memory or pinned host memory only.
int check_copy(cudaGraphNode_t node, const char* what) {
  cudaMemcpy3DParms p = {};
  RGK_TRY(cudaGraphMemcpyNodeGetParams(node, &p));
  if (p.srcArray != nullptr || p.dstArray != nullptr) {
    char msg[256];
    std::snprintf(msg, sizeof(msg), "the %s graph holds a memcpy node on a "
                  "CUDA array, which a conditional body may not hold", what);
    return fail(-1, msg);
  }
  for (const void* ptr : {p.srcPtr.ptr, p.dstPtr.ptr}) {
    cudaPointerAttributes a = {};
    cudaError_t err = cudaPointerGetAttributes(&a, ptr);
    if (err != cudaSuccess) return fail_cuda(err, "cudaPointerGetAttributes");
    if (a.type == cudaMemoryTypeUnregistered) {
      char msg[256];
      std::snprintf(msg, sizeof(msg), "the %s graph holds a memcpy node "
                    "touching pageable host memory, which a conditional "
                    "body may not hold", what);
      return fail(-1, msg);
    }
  }
  return 0;
}

// Walks `graph` and its child graphs: the allowed node types only.
// `nodes` counts them (child graph nodes included).
int check_graph(cudaGraph_t graph, const char* what, long long* nodes) {
  size_t n = 0;
  RGK_TRY(cudaGraphGetNodes(graph, nullptr, &n));
  std::vector<cudaGraphNode_t> list(n);
  if (n > 0) RGK_TRY(cudaGraphGetNodes(graph, list.data(), &n));
  for (cudaGraphNode_t node : list) {
    cudaGraphNodeType t;
    RGK_TRY(cudaGraphNodeGetType(node, &t));
    *nodes += 1;
    switch (t) {
      case cudaGraphNodeTypeKernel:
      case cudaGraphNodeTypeMemset:
      case cudaGraphNodeTypeEmpty:
        break;
      case cudaGraphNodeTypeMemcpy: {
        int rc = check_copy(node, what);
        if (rc != 0) return rc;
        break;
      }
      case cudaGraphNodeTypeGraph: {
        cudaGraph_t child;
        RGK_TRY(cudaGraphChildGraphNodeGetGraph(node, &child));
        int rc = check_graph(child, what, nodes);
        if (rc != 0) return rc;
        break;
      }
      default: {
        char msg[256];
        std::snprintf(msg, sizeof(msg), "the %s graph holds a %s node (node "
                      "type %d), which a conditional body may not hold",
                      what, node_type_name(t), static_cast<int>(t));
        return fail(-1, msg);
      }
    }
  }
  return 0;
}

int check_driver() {
  int v = 0;
  RGK_TRY(cudaDriverGetVersion(&v));
  if (v < kMinDriver) {
    char msg[256];
    std::snprintf(msg, sizeof(msg), "the CUDA driver is %d.%d; a conditional "
                  "WHILE node needs 12.4 or later", v / 1000,
                  (v % 1000) / 10);
    return fail(-1, msg);
  }
  return 0;
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t graph,
                     const cudaGraphNode_t* dep, cudaGraphNodeParams* p) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, graph, dep, nullptr, dep ? 1 : 0, p);
#else
  return cudaGraphAddNode(node, graph, dep, dep ? 1 : 0, p);
#endif
}

// child(g) after `dep` (none when null) in `graph`; *out = the new node,
// or `dep` itself when g is null.
int add_child(cudaGraph_t graph, cudaGraph_t g, cudaGraphNode_t dep,
              cudaGraphNode_t* out) {
  if (g == nullptr) {
    *out = dep;
    return 0;
  }
  RGK_TRY(cudaGraphAddChildGraphNode(out, graph, dep ? &dep : nullptr,
                                     dep ? 1 : 0, g));
  return 0;
}

int add_setter(cudaGraph_t graph, cudaGraphNode_t dep,
               cudaGraphConditionalHandle handle, const void* flag,
               int flag_bytes, long long* runs, cudaGraphNode_t* out) {
  void* args[] = {&handle, &flag, &flag_bytes, &runs};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_condition);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  RGK_TRY(cudaGraphAddKernelNode(out, graph, dep ? &dep : nullptr,
                                 dep ? 1 : 0, &kp));
  return 0;
}

int build(cudaGraph_t outer, cudaGraph_t prologue, cudaGraph_t body,
          cudaGraph_t epilogue, const void* flag, int flag_bytes,
          long long* runs) {
  cudaGraphConditionalHandle handle;
  RGK_TRY(cudaGraphConditionalHandleCreate(&handle, outer, 0, 0));
  cudaGraphNode_t pro, set0, loop, tail;
  int rc = add_child(outer, prologue, nullptr, &pro);
  if (rc == 0) rc = add_setter(outer, pro, handle, flag, flag_bytes, runs,
                               &set0);
  if (rc != 0) return rc;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = handle;
  cp.conditional.type = cudaGraphCondTypeWhile;
  cp.conditional.size = 1;
  RGK_TRY(add_node(&loop, outer, &set0, &cp));
  cudaGraph_t inner = cp.conditional.phGraph_out[0];
  cudaGraphNode_t step, set1;
  rc = add_child(inner, body, nullptr, &step);
  if (rc == 0) rc = add_setter(inner, step, handle, flag, flag_bytes, runs,
                               &set1);
  if (rc == 0) rc = add_child(outer, epilogue, loop, &tail);
  return rc;
}

}  // namespace

extern "C" const char* rgk_while_graph_error() { return g_error; }

extern "C" int rgk_cuda_driver_version(int* out) {
  RGK_TRY(cudaDriverGetVersion(out));
  return 0;
}

// Nodes of `graph`, child graphs walked, into *out; refuses a node that a
// conditional body may not hold.
extern "C" int rgk_graph_check(void* graph, const char* what,
                               long long* out) {
  *out = 0;
  return check_graph(static_cast<cudaGraph_t>(graph), what, out);
}

// prologue and epilogue may be null.  flag: the device bool (flag_bytes 1)
// or int32 (4) the captured graphs write; runs: a device int64 the setter
// adds 1 to at each run.  On success *exec_out is an instantiated graph,
// uploaded on `stream`.
extern "C" int rgk_while_graph_create(void* prologue, void* body,
                                      void* epilogue, const void* flag,
                                      int flag_bytes, long long* runs,
                                      void* stream, void** exec_out) {
  *exec_out = nullptr;
  g_error[0] = '\0';
  int rc = check_driver();
  if (rc != 0) return rc;
  if (body == nullptr) return fail(-1, "a WHILE graph needs a body");
  if (flag_bytes != 1 && flag_bytes != 4)
    return fail(-1, "the flag must be a bool or an int32");
  const char* names[] = {"prologue", "body", "epilogue"};
  void* graphs[] = {prologue, body, epilogue};
  for (int i = 0; i < 3; ++i) {
    long long n = 0;
    if (graphs[i] == nullptr) continue;
    rc = check_graph(static_cast<cudaGraph_t>(graphs[i]), names[i], &n);
    if (rc != 0) return rc;
  }
  cudaGraph_t outer;
  RGK_TRY(cudaGraphCreate(&outer, 0));
  rc = build(outer, static_cast<cudaGraph_t>(prologue),
             static_cast<cudaGraph_t>(body),
             static_cast<cudaGraph_t>(epilogue), flag, flag_bytes, runs);
  cudaGraphExec_t exec = nullptr;
  if (rc == 0) {
    cudaError_t err = cudaGraphInstantiate(&exec, outer, 0);
    if (err != cudaSuccess) rc = fail_cuda(err, "cudaGraphInstantiate");
  }
  if (rc == 0) {
    cudaError_t err =
        cudaGraphUpload(exec, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) {
      rc = fail_cuda(err, "cudaGraphUpload");
      cudaGraphExecDestroy(exec);
    }
  }
  cudaGraphDestroy(outer);
  if (rc == 0) *exec_out = exec;
  return rc;
}

extern "C" int rgk_while_graph_launch(void* exec, void* stream) {
  RGK_TRY(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                          static_cast<cudaStream_t>(stream)));
  return 0;
}

// One phase stamp (see above) on `stream`: acc is a device int64 vector,
// last and slot indices into it (slot -1: mark only).  Returns the launch's
// CUDA error as an int (0 = launched).
extern "C" int rgk_stamp(void* acc, int last, int slot, void* stream) {
  stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(acc), last, slot);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rgk_while_graph_destroy(void* exec) {
  RGK_TRY(cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
  return 0;
}
