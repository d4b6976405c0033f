// The device-resident fit loop for Hopper (sm_90a), called through ctypes:
// the tol-checked stop rule as a one-thread kernel, and the outer CUDA
// graph of a whole fit built around graphs that PyTorch captured.
//
// Replaces: no Pallas kernel. It is the counterpart of the reference's
// lax.while_loop in pycmf_tpu/solvers/common.py:device_fit_core (:164-247):
// the loop's cond (:212-214), the body's stop rule and history write
// (:216-220), and the remainder block under lax.cond (:229-244).
//
// The outer graph of one fit, built once per cache entry
// (solvers/common.py) and launched once per fit:
//
//   gate ─► while (h_loop) { block ─► stop_rule } ─► gate ─► if (h_rem)
//                                                       { remainder ─► rule }
//
// `block` and `remainder` are child-graph nodes holding the graphs PyTorch
// captured of one eval block (eval_every steps and the loss) and of the
// shorter last block; the second gate and the `if` node exist only when
// max_iter % eval_every != 0. Everything a fit may change lives in device
// buffers that eager ops write before the launch, so neither tol nor
// max_iter is baked into the graph:
//
//   ctl  (int64):  [0] i, the next full block   [1] n_full   [2] stop
//                  [3] the remainder ran        [4] address of the history
//   fctl (double): [0] tol   [1] L0   [2] prev
//   hist (double, n_full + 2 slots, NaN-filled): hist[0] = L0, hist[j + 1]
//                  the loss after block j.
//
// The rule is the host loop's (solvers/common.py: run_solver_loop), in
// float64 and in its order: stop when L0 > 0 and (prev - loss) / L0 < tol,
// with round-to-nearest subtraction and division, so both loops stop at the
// same block bit for bit. A non-finite loss also ends the loop: the host
// then raises on the written history, as the reference's finish_device_fit.
//
// Bound: latency. One thread reads six words and writes four per block; a
// block's own kernels take 0.25-110 ms on the main paths (PERF.md §5).

#include <vector>

#include "common.cuh"

namespace pycmf {

enum FitMode : int { kGate = 0, kBlock = 1, kRemainder = 2 };
// which handles a rule node sets: bit 0 the loop's, bit 1 the remainder's
enum FitHandles : int { kSetLoop = 1, kSetRem = 2 };

__global__ void stop_rule_kernel(long long* ctl, double* fctl,
                                 const double* loss, int mode,
                                 cudaGraphConditionalHandle h_loop,
                                 cudaGraphConditionalHandle h_rem,
                                 int handles) {
  long long i = ctl[0];
  const long long n_full = ctl[1];
  long long stop = ctl[2];
  if (mode != kGate) {
    double* hist = reinterpret_cast<double*>(ctl[4]);
    const double l = *loss;
    hist[i + 1] = l;
    if (mode == kRemainder) {
      ctl[3] = 1;
      return;
    }
    const double L0 = fctl[1];
    const double prev = fctl[2];
    stop = !isfinite(l) ||
           (L0 > 0.0 && __ddiv_rn(__dsub_rn(prev, l), L0) < fctl[0]);
    i += 1;
    ctl[0] = i;
    ctl[2] = stop;
    fctl[2] = l;
  }
  if (handles & kSetLoop) cudaGraphSetConditional(h_loop, !stop && i < n_full);
  if (handles & kSetRem) cudaGraphSetConditional(h_rem, !stop && i >= n_full);
}

// The first node type in g (and in its child graphs) that a conditional
// node's body does not take, or -1; *nodes counts every node seen.
cudaError_t first_refused_type(cudaGraph_t g, int* bad, int* nodes) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e != cudaSuccess || n == 0) return e;
  std::vector<cudaGraphNode_t> all(n);
  e = cudaGraphGetNodes(g, all.data(), &n);
  if (e != cudaSuccess) return e;
  for (size_t j = 0; j < n && *bad < 0; ++j) {
    cudaGraphNodeType t;
    e = cudaGraphNodeGetType(all[j], &t);
    if (e != cudaSuccess) return e;
    *nodes += 1;
    switch (t) {
      case cudaGraphNodeTypeKernel:
      case cudaGraphNodeTypeMemcpy:
      case cudaGraphNodeTypeMemset:
      case cudaGraphNodeTypeEmpty:
      case cudaGraphNodeTypeConditional:
        break;
      case cudaGraphNodeTypeGraph: {
        cudaGraph_t child;
        e = cudaGraphChildGraphNodeGetGraph(all[j], &child);
        if (e != cudaSuccess) return e;
        e = first_refused_type(child, bad, nodes);
        if (e != cudaSuccess) return e;
        break;
      }
      default:
        *bad = (int)t;
    }
  }
  return cudaSuccess;
}

cudaError_t add_rule(cudaGraphNode_t* node, cudaGraph_t g,
                     const cudaGraphNode_t* dep, long long* ctl, double* fctl,
                     const double* loss, int mode,
                     cudaGraphConditionalHandle h_loop,
                     cudaGraphConditionalHandle h_rem, int handles) {
  void* args[] = {&ctl, &fctl, &loss, &mode, &h_loop, &h_rem, &handles};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(stop_rule_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, g, dep, dep ? 1 : 0, &p);
}

cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t g,
                            cudaGraphNode_t dep, cudaGraphConditionalHandle h,
                            cudaGraphConditionalNodeType type,
                            cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = type;
  p.conditional.size = 1;
  cudaError_t e = cudaGraphAddNode(node, g, &dep, 1, &p);
  if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return e;
}

// The body of a conditional node: the captured block as a child graph (a
// copy of it), then a rule node in `mode` that sets `handles`.
cudaError_t add_body(cudaGraph_t body, cudaGraph_t block, long long* ctl,
                     double* fctl, const double* loss, int mode,
                     cudaGraphConditionalHandle h_loop, int handles) {
  cudaGraphNode_t child, rule;
  cudaError_t e = cudaGraphAddChildGraphNode(&child, body, nullptr, 0, block);
  if (e != cudaSuccess) return e;
  return add_rule(&rule, body, &child, ctl, fctl, loss, mode, h_loop, 0,
                  handles);
}

struct FitGraph {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  ~FitGraph() {
    if (exec) cudaGraphExecDestroy(exec);
    if (graph) cudaGraphDestroy(graph);
  }
};

cudaError_t build(FitGraph* f, cudaGraph_t block, cudaGraph_t rem,
                  long long* ctl, double* fctl, const double* loss,
                  const double* rem_loss) {
  cudaError_t e = cudaGraphCreate(&f->graph, 0);
  if (e != cudaSuccess) return e;
  cudaGraph_t g = f->graph;
  cudaGraphConditionalHandle h_loop = 0, h_rem = 0;
  e = cudaGraphConditionalHandleCreate(&h_loop, g, 0,
                                       cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return e;
  if (rem) {
    e = cudaGraphConditionalHandleCreate(&h_rem, g, 0,
                                         cudaGraphCondAssignDefault);
    if (e != cudaSuccess) return e;
  }
  cudaGraphNode_t gate, loop;
  e = add_rule(&gate, g, nullptr, ctl, fctl, nullptr, kGate, h_loop, h_rem,
               kSetLoop);
  if (e != cudaSuccess) return e;
  cudaGraph_t body;
  e = add_conditional(&loop, g, gate, h_loop, cudaGraphCondTypeWhile, &body);
  if (e != cudaSuccess) return e;
  e = add_body(body, block, ctl, fctl, loss, kBlock, h_loop, kSetLoop);
  if (e != cudaSuccess) return e;
  if (rem) {
    cudaGraphNode_t gate2, cond;
    e = add_rule(&gate2, g, &loop, ctl, fctl, nullptr, kGate, h_loop, h_rem,
                 kSetRem);
    if (e != cudaSuccess) return e;
    cudaGraph_t rbody;
    e = add_conditional(&cond, g, gate2, h_rem, cudaGraphCondTypeIf, &rbody);
    if (e != cudaSuccess) return e;
    e = add_body(rbody, rem, ctl, fctl, rem_loss, kRemainder, 0, 0);
    if (e != cudaSuccess) return e;
  }
  return cudaGraphInstantiate(&f->exec, g, 0);
}

}  // namespace pycmf

// One stop-rule step outside any graph (mode 1: a block's loss; 2: the
// remainder's), on `stream`: sets no handle. ctl[4] must hold the history's
// address. Returns the CUDA error of the launch (0 on success).
extern "C" int pycmf_stop_rule(long long* ctl, double* fctl,
                               const double* loss, int mode, int device,
                               void* stream) {
  using namespace pycmf;
  DeviceGuard guard(device);
  if (mode != kBlock && mode != kRemainder) return (int)cudaErrorInvalidValue;
  stop_rule_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      ctl, fctl, loss, mode, 0, 0, 0);
  return (int)cudaGetLastError();
}

// The node types of a captured graph (and of its child graphs): *bad the
// first type a conditional body refuses (a cudaGraphNodeType), or -1;
// *nodes the number of nodes. Returns a CUDA error (0 on success).
extern "C" int pycmf_fit_graph_check(void* graph, int device, int* bad,
                                     int* nodes) {
  using namespace pycmf;
  DeviceGuard guard(device);
  *bad = -1;
  *nodes = 0;
  return (int)first_refused_type(static_cast<cudaGraph_t>(graph), bad, nodes);
}

// Build and instantiate the outer graph of a fit around `block` (a
// cudaGraph_t of one eval block, writing its loss to *loss as a double)
// and, unless null, `rem` (the remainder block, loss to *rem_loss). Both
// are copied into the outer graph; the caller keeps the memory they read.
// *out receives the handle for pycmf_fit_graph_launch/_destroy. Returns a
// CUDA error (0 on success; nothing is left allocated on failure).
extern "C" int pycmf_fit_graph_create(void* block, void* rem, long long* ctl,
                                      double* fctl, const double* loss,
                                      const double* rem_loss, int device,
                                      void** out) {
  using namespace pycmf;
  DeviceGuard guard(device);
  *out = nullptr;
  if (!block || (rem && !rem_loss)) return (int)cudaErrorInvalidValue;
  FitGraph* f = new FitGraph;
  cudaError_t e = build(f, static_cast<cudaGraph_t>(block),
                        static_cast<cudaGraph_t>(rem), ctl, fctl, loss,
                        rem_loss);
  if (e != cudaSuccess) {
    delete f;
    return (int)e;
  }
  *out = f;
  return 0;
}

// Launch a fit's outer graph on `stream`.
extern "C" int pycmf_fit_graph_launch(void* fit, int device, void* stream) {
  using namespace pycmf;
  DeviceGuard guard(device);
  return (int)cudaGraphLaunch(static_cast<FitGraph*>(fit)->exec,
                              static_cast<cudaStream_t>(stream));
}

// Destroy a fit's outer graph (its executable and its graph).
extern "C" int pycmf_fit_graph_destroy(void* fit, int device) {
  using namespace pycmf;
  DeviceGuard guard(device);
  delete static_cast<FitGraph*>(fit);
  return 0;
}
